"""The fused ingest's borderline rescan on a worker thread
(needle_tpu_torch/fingerprint/torch_impl.py::IngestDispatcher), on the CPU.

Each dispatched lane chunk is collected and rescanned while later segments
are still being added; `threading=False` keeps the rescan inline in
finish(). Both must give bit for bit the hashes of needle_tpu's JAX ingest
(the canonical oracle's), and an error in the worker must fail finish().
A margin of 1e30 flags every hash, so every chunk has a rescan to do."""

import shutil
import threading

import numpy as np
import pytest

from needle_tpu.fingerprint import jax_impl as J
from needle_tpu_torch.fingerprint import torch_impl as T

SECS = (5, 25, 6, 25, 9)  # frame buckets 160 and 224 at 16 kHz


def _noise(rng, n, amp=6000):
    return (rng.standard_normal(n) * amp).astype(np.int16)


@pytest.fixture
def segs():
    rng = np.random.default_rng(13)
    return [_noise(rng, 16000 * s) for s in SECS]


@pytest.fixture
def paranoid(monkeypatch):
    """Two lanes a chunk, every hash flagged."""
    monkeypatch.setattr(T, "LANES", 2)
    monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", "1e30")


def _run(segs, threading_):
    d = T.IngestDispatcher(16000, 1, "cpu", threading=threading_)
    for i, s in enumerate(segs):
        d.add(i, s)
    out = d.finish()
    return [out[i] for i in range(len(segs))]


def _chunks(segs):
    """Lane chunks (full and partial) the segments make, and their hashes."""
    d = T.IngestDispatcher(16000, 1, "cpu")
    geo = [d.lane_geometry(len(s)) for s in segs]
    buckets = [nf_b for _, nf_b in geo]
    n_chunks = sum(-(-buckets.count(b) // T.LANES) for b in set(buckets))
    return n_chunks, len(set(buckets)), sum(n for n, _ in geo)


def test_threaded_equals_inline_and_jax(segs, paranoid):
    n_chunks, n_buckets, _ = _chunks(segs)
    assert (n_chunks, n_buckets) == (3, 2)
    threaded = T.fingerprint_ingest_batch(segs, 16000, 1, device="cpu")
    inline = _run(segs, False)
    want = J.fingerprint_ingest_jax_batch(segs, 16000, 1)
    for t, i, w in zip(threaded, inline, want):
        assert t.dtype == np.uint32
        np.testing.assert_array_equal(t, w)
        np.testing.assert_array_equal(i, w)


def test_worker_rescan_replaces_every_flagged_hash(segs, paranoid,
                                                   monkeypatch):
    """With the device's hashes spoiled, every one flagged, the result is
    still the JAX ingest's: the worker recomputed each of them."""
    batched = T.ingest_fingerprint_batched

    def spoiled(*args, **kw):
        hashes, flags = batched(*args, **kw)
        return hashes ^ 1, flags

    monkeypatch.setattr(T, "ingest_fingerprint_batched", spoiled)
    got = T.fingerprint_ingest_batch(segs, 16000, 1, device="cpu")
    for g, w in zip(got, J.fingerprint_ingest_jax_batch(segs, 16000, 1)):
        np.testing.assert_array_equal(g, w)


def test_analyze_threading_on_and_off_writes_same_files(tmp_path, monkeypatch):
    """A 3-episode WAV season, analyzed with and without threading (the
    CLI's --no-threading), writes byte-identical .needle.dat files."""
    from needle_tpu_torch import Analyzer
    from needle_tpu_torch.data import frame_hash_data_path
    from needle_tpu_torch.testing import make_synthetic_season

    monkeypatch.setattr(T, "LANES", 2)
    monkeypatch.setenv("NEEDLE_TPU_EXACT_EPS", "1e-3")
    paths, _, _ = make_synthetic_season(
        tmp_path / "on", num_episodes=3, episode_secs=40, opening_secs=12,
        ending_secs=8, opening_offset_range=(2.0, 6.0), seed=5,
    )
    shutil.copytree(tmp_path / "on", tmp_path / "off")
    off = [tmp_path / "off" / p.name for p in paths]
    for files, threading_ in ((paths, True), (off, False)):
        Analyzer(files, device="cpu").with_include_endings(True).run(
            0.3, persist=True, threading=threading_)
    for a, b in zip(paths, off):
        da, db = frame_hash_data_path(a), frame_hash_data_path(b)
        assert da.exists() and da.read_bytes() == db.read_bytes()


def test_worker_error_fails_finish(segs, paranoid, monkeypatch):
    """An error raised by the oracle on the worker thread comes out of
    finish(); no hashes are returned."""
    from needle_tpu_torch.fingerprint import ingest_oracle

    raised = threading.Event()
    orig = ingest_oracle.ingest_hashes_mid_oracle

    def boom(*args, **kw):
        if threading.current_thread() is not threading.main_thread():
            raised.set()
            raise RuntimeError("rescan failed")
        return orig(*args, **kw)

    monkeypatch.setattr(ingest_oracle, "ingest_hashes_mid_oracle", boom)
    d = T.IngestDispatcher(16000, 1, "cpu")
    for i, s in enumerate(segs):
        d.add(i, s)
    assert raised.wait(timeout=120), "no chunk reached the worker"
    with pytest.raises(RuntimeError, match="rescan failed"):
        d.finish()


def test_spans_per_chunk(segs, paranoid, monkeypatch):
    """ingest.rescan once per chunk with flags, whose `flagged` fields sum
    to every hash; ingest.collect once per chunk; ingest.rescan_wait once."""
    from needle_tpu_torch import tracing

    seen = []
    orig = tracing.span

    def spy(name, **kw):
        seen.append((name, kw))
        return orig(name, **kw)

    monkeypatch.setattr(tracing, "span", spy)
    n_chunks, _, n_hashes = _chunks(segs)
    out = T.fingerprint_ingest_batch(segs, 16000, 1, device="cpu")
    assert sum(len(o) for o in out) == n_hashes
    rescans = [kw["flagged"] for name, kw in seen if name == "ingest.rescan"]
    assert len(rescans) == n_chunks and sum(rescans) == n_hashes
    names = [name for name, _ in seen]
    assert names.count("ingest.collect") == n_chunks
    assert names.count("ingest.rescan_wait") == 1
