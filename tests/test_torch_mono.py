"""The port's pre-decoded mono route (needle_tpu_torch fingerprint_batch and
the Analyzer's compressed-media path, both lanes of the fused ingest at
11025 Hz, on the CPU) against needle_tpu's JAX program on the CPU and the
numpy oracle.

Hashes are compared exactly (the borderline rescan makes them the
oracle's). Classifier values are compared within 5e-6, half the 1e-5
borderline margin: torch and XLA sum float32 products in different
orders."""

import numpy as np
import pytest

from needle_tpu import ingest
from needle_tpu.fingerprint import jax_impl as J
from needle_tpu.fingerprint.numpy_impl import fingerprint_numpy
from needle_tpu.testing import _music_like
from needle_tpu_torch import tracing
from needle_tpu_torch.fingerprint import torch_impl as T

VALUE_TOL = 5e-6
RATE = 11025


def _mono(rng, secs, noise=False):
    n = int(secs * RATE)
    x = rng.standard_normal(n) * 0.4 if noise else _music_like(rng, n, RATE)
    return np.clip(x * 9000, -32768, 32767).astype(np.int16)


def _spy_rescan(monkeypatch):
    """The flagged hashes of each chunk the ingest rescans (span
    ingest.rescan, on the rescan worker)."""
    flagged = []
    orig = tracing.span

    def spy(name, **kw):
        if name == "ingest.rescan":
            flagged.append(kw.get("flagged", 0))
        return orig(name, **kw)

    monkeypatch.setattr(tracing, "span", spy)
    return flagged


@pytest.mark.parametrize("eps", [None, "3e-3"])
def test_fingerprint_batch_equals_jax_and_numpy(rng, monkeypatch, eps):
    """Several frame buckets, more episodes than lanes, an episode too
    short for one hash; with a raised margin the rescan really runs."""
    if eps is not None:
        monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", eps)
    monkeypatch.setattr(T, "LANES", 2)
    flagged = _spy_rescan(monkeypatch)
    monos = [_mono(rng, s, noise=k % 2 == 1)
             for k, s in enumerate((12.0, 12.5, 30.0, 7.0, 12.2))]
    monos.append(np.zeros(100, np.int16))
    got = T.fingerprint_batch(monos, device="cpu")
    want = J.fingerprint_jax_batch(monos)
    ingest = T.fingerprint_ingest_batch(monos, RATE, 1, device="cpu")
    assert len(got) == len(monos) == len(ingest)
    for g, w, i, m in zip(got, want, ingest, monos):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, i)
        np.testing.assert_array_equal(g, fingerprint_numpy(m))
    assert len(got[-1]) == 0
    if eps is not None:
        assert flagged and sum(flagged) > 10


def test_wrappers_equal_jax(rng):
    mono = _mono(rng, 10.0)
    np.testing.assert_array_equal(T.fingerprint(mono, device="cpu"),
                                  J.fingerprint_jax(mono))
    stereo = np.stack([mono, _mono(rng, 10.0)], axis=1).reshape(-1)
    np.testing.assert_array_equal(T.fingerprint_stereo(stereo, device="cpu"),
                                  J.fingerprint_jax_stereo(stereo))
    assert T.fingerprint_batch([], device="cpu") == []


@pytest.mark.parametrize("noise", [False, True])
def test_classifier_values_close_to_jax(rng, noise):
    mono = _mono(rng, 9.0, noise)
    vt, nt = T.classifier_values(mono, device="cpu")
    vj, nj = J.classifier_values_jax(mono)
    assert vt.shape == vj.shape and vt.dtype == np.float32
    assert nt.shape == nj.shape
    assert np.max(np.abs(vt - vj)) < VALUE_TOL
    np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-6)
    empty = T.classifier_values(np.zeros(10, np.int16), device="cpu")
    assert empty[0].shape == (0, 16) and empty[1].shape == (0,)


@pytest.mark.skipif(not ingest.native_available(), reason="native ingest unavailable")
def test_analyzer_mixed_media_dat_bytes_equal(tmp_path, rng):
    """A library of .mkv (PCM), .mp4 (AAC) and .wav episodes sharing an
    opening and an ending: the port's Analyzer writes .needle.dat files
    byte-identical to needle_tpu's, and the search finds the opening."""
    import shutil

    from needle_tpu import Analyzer as JaxAnalyzer
    from needle_tpu.testing import write_wav_i16
    from needle_tpu_torch import Analyzer, Comparator

    rate = 16000
    opening = _music_like(rng, 20 * rate, rate)
    ending = _music_like(rng, 15 * rate, rate)
    ours, ref = tmp_path / "torch", tmp_path / "jax"
    ours.mkdir()
    for e, ext in enumerate(("mkv", "mp4", "wav", "mkv")):
        body = _music_like(rng, 80 * rate, rate) * 0.5
        at = int((3 + 2 * e) * rate)
        body[at : at + len(opening)] = opening
        body[-len(ending) - rate : -rate] = ending
        pcm = np.clip(body * 9000, -32768, 32767).astype(np.int16)
        path = ours / f"ep{e}.{ext}"
        if ext == "wav":
            write_wav_i16(path, pcm, rate, 1)
        elif ext == "mp4":
            ingest.write_media(path, pcm, rate, 1, codec="aac")
        else:
            ingest.write_media(path, np.repeat(pcm, 2), rate, 2,
                               codec="pcm_s16le")
    shutil.copytree(ours, ref)
    paths = sorted(ours.iterdir())
    Analyzer(paths, device="cpu").with_include_endings(True).run(0.3, persist=True)
    JaxAnalyzer(sorted(ref.iterdir()), backend="jax").with_include_endings(
        True
    ).run(0.3, persist=True)
    dats = sorted(p.name for p in ours.glob("*.needle.dat"))
    assert len(dats) == 4
    for name in dats:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name
    res = Comparator(paths, device="cpu").with_include_endings(True).run(
        analyze=False, display=False, use_skip_files=False,
        write_skip_files=False,
    )
    assert all(r.opening is not None for r in res)
