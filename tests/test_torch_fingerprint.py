"""The port's fused ingest (needle_tpu_torch/fingerprint, on the CPU)
against needle_tpu's JAX program on the CPU and against the canonical host
oracle.

Integer stages (decimation, downmix) and the static plan are compared
exactly. Float stages are compared with a stated tolerance: torch and XLA
sum float32 products in different orders, so pre-quantization classifier
values may differ by a few float32 ulps; the bound is 5e-6, half the 1e-5
borderline margin (the same gate the JAX package applies on hardware).
Hashes after the borderline rescan are exactly the oracle's, so they are
compared exactly."""

import numpy as np
import pytest
import torch

from needle_tpu.fingerprint import ingest_oracle as JO
from needle_tpu.fingerprint import jax_impl as J
from needle_tpu.fingerprint.decimate import _HB_MAIN, _HB_RELAXED, _halfband_q14
from needle_tpu.fingerprint.numpy_impl import downmix_stereo_i16
from needle_tpu_torch.fingerprint import ingest_oracle as TO
from needle_tpu_torch.fingerprint import plan
from needle_tpu_torch.fingerprint import torch_impl as T

VALUE_TOL = 5e-6


def _noise(rng, n, amp=6000):
    # white noise concentrates classifier values near the trained
    # thresholds: the worst case for borderline flagging
    return (rng.standard_normal(n) * amp).astype(np.int16)


def _music(rng, n_frames, rate, channels):
    t = np.arange(n_frames) / rate
    x = np.zeros(n_frames)
    for f in rng.uniform(110, 1800, size=6):
        x += rng.uniform(0.05, 0.2) * np.sin(2 * np.pi * f * t)
    x += 0.01 * rng.standard_normal(n_frames)
    x = np.repeat(x[:, None], channels, axis=1)
    if channels == 2:
        x[:, 1] *= 0.8
    return np.clip(x * 30000, -32768, 32767).astype(np.int16).reshape(-1)


# -- the static plan ----------------------------------------------------------


@pytest.mark.parametrize("rate", [8000, 11025, 11025 * 2, 12000, 22050 // 2 * 3])
def test_resample_plan_equals_original(rate):
    for a, b in zip(plan._resample_plan(rate), J._resample_plan(rate)):
        np.testing.assert_array_equal(a, b)
    for nf in (256, 1280, 5120):
        assert plan._ingest_dims(rate, nf) == J._ingest_dims(rate, nf)
    for n in (0, 1, 12345, 9_600_000):
        for ch in (1, 2):
            assert plan.resampled_length(n, rate, ch) == J.resampled_length(
                n, rate, ch
            )


def test_tables_and_constants_equal_original(monkeypatch):
    for a, b in zip(plan._dft_tables() + plan._classifier_tables(),
                    J._dft_tables() + J._classifier_tables()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (plan.LANES, plan._ROWS_PER_FRAME, plan._FRAME_REMAINDER,
            plan._RS_HALF_TAPS) == (J.LANES, J._ROWS_PER_FRAME,
                                    J._FRAME_REMAINDER, J._RS_HALF_TAPS)
    for n in (1, 257, 2413, 4846, 100000):
        assert plan.bucket_frames(n) == J._bucket_frames(n)
    assert plan._exact_eps() == J._exact_eps()
    monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", "3e-4")
    assert plan._exact_eps() == J._exact_eps()


# -- exact integer stages -----------------------------------------------------


@pytest.mark.parametrize("design", [_HB_MAIN, _HB_RELAXED])
@pytest.mark.parametrize("channels,n", [(1, 4001), (2, 3000)])
def test_decimation_exact(rng, design, channels, n):
    x = rng.integers(-32768, 32768, size=(n, channels)).astype(np.int32)
    x[:50] = 32767  # saturating stretch: the clip must match too
    odd_q, c0 = _halfband_q14(*design)
    got = T._decimate2_hb_i32(torch.from_numpy(x)[None], odd_q, c0)[0].numpy()
    np.testing.assert_array_equal(
        got, np.asarray(J._device_decimate2_hb_i32(x, odd_q, c0))
    )
    np.testing.assert_array_equal(got, JO.decimate2_hb_np(x, odd_q, c0))


def test_downmix_exact(rng):
    x = rng.integers(-32768, 32768, size=(5000, 2)).astype(np.int16)
    x[:4] = [[-1, 0], [-3, 0], [1, 0], [-32768, -32768]]  # rounding edges
    got = T._downmix(torch.from_numpy(x.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, downmix_stereo_i16(x.reshape(-1)))
    np.testing.assert_array_equal(
        got, np.asarray(J.downmix_stereo_i16_jnp(x.reshape(-1))).astype(np.int32)
    )


def test_accurate_log32_matches_jax(rng):
    """Bit-exact against JAX evaluating the same float32 operations one by
    one; within 2 ulp of the jitted JAX program, where XLA contracts
    multiply-adds into fused multiply-adds (one rounding fewer each); and
    within 5e-7 of the float64 log."""
    import jax

    xs = np.concatenate(
        [
            np.exp(rng.uniform(np.log(1e-3), np.log(1e3), size=100000)),
            1.0 + rng.normal(0, 1e-4, size=50000),
            [1.0, np.nextafter(1.0, 0.0), np.nextafter(1.0, 2.0), 0.5, 2.0],
        ]
    ).astype(np.float32)
    got = T._accurate_log32(torch.from_numpy(xs)).numpy()
    with jax.disable_jit():
        np.testing.assert_array_equal(got, np.asarray(J._accurate_log32(xs)))
    want = np.asarray(jax.jit(J._accurate_log32)(xs))
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1e-30)))
    assert np.max(np.abs(got - want) / ulp) <= 2.0
    ref = np.log(xs.astype(np.float64))
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) < 5e-7


# -- the fused program --------------------------------------------------------

CASES = [(16000, 1, 10.0), (44100, 2, 8.0)]


@pytest.mark.parametrize("in_rate,channels,secs", CASES)
def test_classifier_values_close_to_jax(in_rate, channels, secs):
    rng = np.random.default_rng(in_rate + channels)
    seg = _noise(rng, int(in_rate * secs) * channels)
    vt, nt, dec, nf_b = T.ingest_classifier_values(seg, in_rate, channels,
                                                   device="cpu")
    vj, nj, dec_j, nf_j = J.ingest_classifier_values_jax(seg, in_rate, channels)
    assert (dec, nf_b) == (dec_j, nf_j) and vt.shape == vj.shape
    assert np.max(np.abs(vt - vj)) < VALUE_TOL
    # chroma norms: float32 sums of large energies, relative tolerance
    np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-6)
    # and against the canonical float64 oracle (the margin's premise)
    n_sub = len(vt)
    vo, _ = TO.ingest_values_oracle(seg, len(seg), in_rate, channels, dec,
                                    nf_b, n_sub)
    assert np.max(np.abs(vt - vo)) < VALUE_TOL


@pytest.mark.parametrize("in_rate,channels,secs", CASES)
def test_ingest_hashes_equal_jax_and_oracle(in_rate, channels, secs):
    rng = np.random.default_rng(7 * in_rate + channels)
    music = _music(rng, int(in_rate * secs), in_rate, channels)
    noise = _noise(rng, int(in_rate * secs / 2) * channels)
    segs = [music, noise]
    got = T.fingerprint_ingest_batch(segs, in_rate, channels, device="cpu")
    want = J.fingerprint_ingest_jax_batch(segs, in_rate, channels)
    d = T.IngestDispatcher(in_rate, channels, "cpu")
    for g, w, s in zip(got, want, segs):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
        n_sub, nf_b = d.lane_geometry(len(s))
        np.testing.assert_array_equal(
            g, TO.ingest_hashes_full_oracle(s, len(s), in_rate, channels,
                                            d.dec_factor, nf_b, n_sub)
        )


def test_ingest_respects_n_valid(rng):
    """Samples past n_valid are zeros: the hashes equal the truncated
    segment's and the JAX program's."""
    seg = _noise(rng, 16000 * 8)
    n_valid = 16000 * 6
    got = T.fingerprint_ingest_batch([seg], 16000, 1, [n_valid], device="cpu")[0]
    cut = T.fingerprint_ingest_batch([seg[:n_valid]], 16000, 1, device="cpu")[0]
    np.testing.assert_array_equal(got, cut)
    np.testing.assert_array_equal(
        got, J.fingerprint_ingest_jax_batch([seg], 16000, 1, [n_valid])[0]
    )


def test_lane_chunks(rng, monkeypatch):
    """More segments than lanes: full chunks dispatch as they fill, the
    partial one at finish(), every result lands on its own segment."""
    monkeypatch.setattr(T, "LANES", 2)
    segs = [_noise(rng, 16000 * s) for s in (5, 6, 5, 9, 5)]
    got = T.fingerprint_ingest_batch(segs, 16000, 1, device="cpu")
    for g, s in zip(got, segs):
        np.testing.assert_array_equal(
            g, T.fingerprint_ingest_batch([s], 16000, 1, device="cpu")[0]
        )


def test_rescan_fires_and_keeps_hashes(rng, monkeypatch):
    """The equality above is not vacuous: with a paranoid margin every hash
    is flagged and rescanned, and the output is unchanged."""
    from needle_tpu_torch import tracing

    seg = _noise(rng, 16000 * 6)
    default = T.fingerprint_ingest_batch([seg], 16000, 1, device="cpu")[0]
    flagged = {}
    orig = tracing.span

    def spy(name, **kw):
        if name == "ingest.rescan":
            flagged["n"] = kw.get("flagged", 0)
        return orig(name, **kw)

    monkeypatch.setattr(tracing, "span", spy)
    monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", "1e30")
    paranoid = T.fingerprint_ingest_batch([seg], 16000, 1, device="cpu")[0]
    assert flagged.get("n") == len(paranoid)
    np.testing.assert_array_equal(default, paranoid)


@pytest.mark.parametrize("in_rate,channels", [(16000, 1), (44100, 2), (11025, 1)])
def test_oracle_copy_equals_original(in_rate, channels):
    rng = np.random.default_rng(3)
    seg = _noise(rng, in_rate * channels * 6)
    n_valid = int(len(seg) * 0.8) // channels * channels
    d = T.IngestDispatcher(in_rate, channels, "cpu")
    n_sub, nf_b = d.lane_geometry(n_valid)
    args = (seg, n_valid, in_rate, channels, d.dec_factor, nf_b)
    ranges = [(0, 5), (17, 40), (n_sub - 4, n_sub)]
    for a, b in zip(TO.ingest_hashes_ranges_oracle(*args, ranges),
                    JO.ingest_hashes_ranges_oracle(*args, ranges)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        TO.ingest_hashes_full_oracle(*args, n_sub),
        JO.ingest_hashes_full_oracle(*args, n_sub),
    )
    for a, b in zip(TO.ingest_values_oracle(*args, n_sub),
                    JO.ingest_values_oracle(*args, n_sub)):
        np.testing.assert_array_equal(a, b)


def test_empty_and_short_segments():
    assert T.fingerprint_ingest_batch([], 16000, 1, device="cpu") == []
    out = T.fingerprint_ingest_batch(
        [np.zeros(100, np.int16), np.zeros(16000 * 5, np.int16)], 16000, 1,
        device="cpu",
    )
    assert len(out[0]) == 0 and out[0].dtype == np.uint32
    np.testing.assert_array_equal(
        out[1], J.fingerprint_ingest_jax_batch([np.zeros(16000 * 5, np.int16)],
                                               16000, 1)[0]
    )
