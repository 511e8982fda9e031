"""The port's own copies of needle_tpu's host modules (needle_tpu_torch's
duration, data, util, errors, constants, _shapes, search/oracle,
fingerprint/{constants,decimate,numpy_impl,ingest_oracle,oracle}, ingest's
host resampler, testing, comparator, analyzer and cli) against the
originals.

Each side builds its own objects from the same numpy inputs, made from
seeds, and the comparison is exact: Durations as (secs, nanos), files
byte for byte, RunEntry lists as tuples of their Ord keys in heap order,
SearchResults field by field, hashes bit for bit. Objects of the two
packages never compare equal to each other, so nothing here compares them
directly."""

import contextlib
import io
import shutil
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import needle_tpu._shapes as j_shapes
import needle_tpu.analyzer as j_analyzer
import needle_tpu.comparator as j_comparator
import needle_tpu.constants as j_constants
import needle_tpu.data as j_data
import needle_tpu.duration as j_duration
import needle_tpu.errors as j_errors
import needle_tpu.fingerprint.constants as j_fconstants
import needle_tpu.fingerprint.decimate as j_decimate
import needle_tpu.fingerprint.ingest_oracle as j_ingest_oracle
import needle_tpu.fingerprint.numpy_impl as j_numpy_impl
import needle_tpu.fingerprint.oracle as j_fp_oracle
import needle_tpu.ingest as j_ingest
import needle_tpu.search.oracle as j_oracle
import needle_tpu.testing as j_testing
import needle_tpu.util as j_util
from needle_tpu_torch import _shapes as t_shapes
from needle_tpu_torch import analyzer as t_analyzer
from needle_tpu_torch import comparator as t_comparator
from needle_tpu_torch import constants as t_constants
from needle_tpu_torch import data as t_data
from needle_tpu_torch import duration as t_duration
from needle_tpu_torch import errors as t_errors
from needle_tpu_torch import ingest as t_ingest
from needle_tpu_torch import testing as t_testing
from needle_tpu_torch import util as t_util
from needle_tpu_torch.fingerprint import constants as t_fconstants
from needle_tpu_torch.fingerprint import decimate as t_decimate
from needle_tpu_torch.fingerprint import ingest_oracle as t_ingest_oracle
from needle_tpu_torch.fingerprint import numpy_impl as t_numpy_impl
from needle_tpu_torch.fingerprint import oracle as t_fp_oracle
from needle_tpu_torch.search import oracle as t_oracle

STEP = 247619033  # ~0.248 s per hash, in ns


def _canon(x):
    """Package-neutral form: a RunEntry as its Ord key (every field,
    Durations in nanoseconds), a Duration as (secs, nanos), containers
    element by element."""
    if hasattr(x, "ord_key"):
        return ("RunEntry",) + x.ord_key()
    if hasattr(x, "subsec_nanos"):
        return ("Duration", x.secs, x.subsec_nanos)
    if isinstance(x, (list, tuple)):
        return type(x)(_canon(v) for v in x)
    return x


def _fh_fields(fh):
    return (
        fh.opening_hashes.tolist(), fh.opening_ts_nanos.tolist(),
        fh.ending_hashes.tolist(), fh.ending_ts_nanos.tolist(),
        _canon(fh.hash_duration()), fh.md5(),
    )


# -- duration ------------------------------------------------------------------

_F32 = st.floats(min_value=0.0, max_value=1e7, allow_nan=False, width=32)


@settings(max_examples=300, deadline=None, database=None)
@given(secs=_F32, factor=st.floats(min_value=0.0, max_value=1.0, width=32),
       other=_F32)
def test_duration_f32_arithmetic(secs, factor, other):
    t = t_duration.Duration.from_secs_f32(secs)
    j = j_duration.Duration.from_secs_f32(secs)
    t2 = t_duration.Duration.from_secs_f32(other)
    j2 = j_duration.Duration.from_secs_f32(other)
    assert _canon(t) == _canon(j)
    assert _canon(t.mul_f32(factor)) == _canon(j.mul_f32(factor))
    assert _canon(t.mul_f64(float(factor))) == _canon(j.mul_f64(float(factor)))
    assert t.as_millis() == j.as_millis()
    assert t.as_secs_f32().tobytes() == j.as_secs_f32().tobytes()
    assert t.as_secs_f64() == j.as_secs_f64()
    assert repr(t) == repr(j)
    for op in ("__lt__", "__le__", "__gt__", "__ge__", "__eq__"):
        assert getattr(t, op)(t2) == getattr(j, op)(j2), op
    assert _canon(t + t2) == _canon(j + j2)
    assert _canon(t.saturating_sub(t2)) == _canon(j.saturating_sub(j2))
    if t >= t2:
        assert _canon(t - t2) == _canon(j - j2)
    else:
        with pytest.raises(OverflowError):
            t - t2
        with pytest.raises(OverflowError):
            j - j2


@settings(max_examples=200, deadline=None, database=None)
@given(nanos=st.integers(min_value=0, max_value=10**16),
       secs_f64=st.floats(min_value=0.0, max_value=1e9, allow_nan=False))
def test_duration_constructors(nanos, secs_f64):
    for name, arg in (("from_nanos", nanos), ("from_millis", nanos // 10**6),
                      ("from_secs", nanos // 10**9),
                      ("from_secs_f64", secs_f64)):
        t = getattr(t_duration.Duration, name)(arg)
        j = getattr(j_duration.Duration, name)(arg)
        assert _canon(t) == _canon(j), name
        assert repr(t) == repr(j) and hash(t) == hash(j) and bool(t) == bool(j)
    assert _canon(t_duration.Duration(nanos // 10**9, nanos % 10**9)) == _canon(
        j_duration.Duration(nanos // 10**9, nanos % 10**9))


# -- data files --------------------------------------------------------------


def _hash_arrays(seed, n_open, n_end):
    rng = np.random.default_rng(seed)
    oh = rng.integers(0, 2**32, size=n_open, dtype=np.uint32)
    eh = rng.integers(0, 2**32, size=n_end, dtype=np.uint32)
    ot = (2600090703 + np.arange(n_open) * STEP).astype(np.int64)
    et = (1_200_000_000_123 + np.arange(n_end) * STEP).astype(np.int64)
    return oh, ot, eh, et


@pytest.mark.parametrize("n_open,n_end,hd_ns", [
    (0, 0, 300_000_000), (7, 0, 123_800_000), (2421, 1210, 300_000_000),
    (3, 5, 5_000_000_001),
])
def test_needle_dat_bytes_and_cross_reading(tmp_path, n_open, n_end, hd_ns):
    arrays = _hash_arrays(n_open + n_end, n_open, n_end)
    md5 = f"{n_open:08x}" * 4
    t = t_data.FrameHashes(*arrays, t_duration.Duration.from_nanos(hd_ns), md5)
    j = j_data.FrameHashes(*arrays, j_duration.Duration.from_nanos(hd_ns), md5)
    assert t.to_bytes() == j.to_bytes()
    assert repr(t) == repr(j)
    assert _canon(t.opening_data()) == _canon(j.opening_data())
    assert _canon(t.ending_data()) == _canon(j.ending_data())
    t.save(tmp_path / "t.needle.dat")
    j.save(tmp_path / "j.needle.dat")
    from_j = t_data.FrameHashes.from_path(tmp_path / "j.needle.dat")
    from_t = j_data.FrameHashes.from_path(tmp_path / "t.needle.dat")
    assert _fh_fields(from_j) == _fh_fields(j) == _fh_fields(from_t)


@pytest.mark.parametrize("name", ["ep1.mp4", "ep1", "show.s01e02.mkv", "a b.wav"])
def test_data_paths(tmp_path, name):
    video = tmp_path / name
    assert t_data.frame_hash_data_path(video) == j_data.frame_hash_data_path(video)
    assert t_data.skip_file_path(video) == j_data.skip_file_path(video)


@pytest.mark.parametrize("opening,ending", [
    (None, (1331.664387072, 1419.0249)),
    ((12.5, 90.0), None),
    ((0.123456789, 1e6), (3.0, 4.0)),
    (None, None),
])
def test_skip_file_bytes(tmp_path, opening, ending):
    md5 = "0123456789abcdef" * 2
    t = t_data.SkipFile(opening=opening, ending=ending, md5=md5)
    j = j_data.SkipFile(opening=opening, ending=ending, md5=md5)
    assert t.to_json_bytes() == j.to_json_bytes()
    j.write(tmp_path / "j.json")
    t.write(tmp_path / "t.json")
    a = t_data.SkipFile.read(tmp_path / "j.json")
    b = j_data.SkipFile.read(tmp_path / "t.json")
    assert (a.opening, a.ending, a.md5) == (b.opening, b.ending, b.md5)


def test_corrupt_needle_dat_raises_the_ports_error():
    good = t_data.FrameHashes(*_hash_arrays(1, 4, 2),
                              t_duration.Duration.from_millis(300), "x").to_bytes()
    for bad in (good[:7], good[:-3], b"\x01" + good[1:]):
        with pytest.raises(t_errors.Error) as t_err:
            t_data.FrameHashes.from_bytes(bad)
        with pytest.raises(j_errors.Error) as j_err:
            j_data.FrameHashes.from_bytes(bad)
        assert str(t_err.value) == str(j_err.value)


# -- util, errors, constants, shapes -------------------------------------------


@pytest.mark.parametrize("nanos", [0, 999_999_999, 59_999_999_999, 60 * 10**9,
                                   3_599_999_999_999, 86_400_123_456_789])
def test_format_time(nanos):
    assert t_util.format_time(t_duration.Duration.from_nanos(nanos)) == \
        j_util.format_time(j_duration.Duration.from_nanos(nanos))


@pytest.mark.parametrize("size", [8 * 1024, 10_000, 100_000])
def test_compute_header_md5sum(tmp_path, size):
    p = tmp_path / "v.bin"
    p.write_bytes(np.random.default_rng(size).bytes(size))
    assert t_util.compute_header_md5sum(p) == j_util.compute_header_md5sum(p)
    short = tmp_path / "short.bin"
    short.write_bytes(b"x" * 100)
    with pytest.raises(OSError):
        t_util.compute_header_md5sum(short)


def test_find_video_files(tmp_path, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_ALLOW_AUDIO", "1")
    t_testing.write_wav_i16(tmp_path / "a.wav", np.zeros(9000, np.int16), 16000)
    (tmp_path / "b.mkv").write_bytes(b"\x1aE\xdf\xa3" + bytes(9000))
    (tmp_path / "a.needle.dat").write_bytes(b"")
    (tmp_path / "notes.txt").write_bytes(b"hello" * 100)
    for full in (False, True):
        got = sorted(t_util.find_video_files([tmp_path], full=full))
        assert got == sorted(j_util.find_video_files([tmp_path], full=full))
    monkeypatch.setenv("NEEDLE_TPU_ALLOW_AUDIO", "0")
    assert t_util.find_video_files([tmp_path], full=False) == \
        j_util.find_video_files([tmp_path], full=False)
    with pytest.raises(t_errors.PathNotFound):
        t_util.find_video_files([tmp_path / "missing"])


@pytest.mark.parametrize("name,args", [
    ("FrameHashDataNotFound", ("/x/y.needle.dat",)),
    ("FrameHashDataInvalidVersion", ()),
    ("FrameHashDataNoEnding", ()),
    ("AnalyzerMissingPaths", ()),
    ("PathNotFound", ("rel/p.mkv",)),
])
def test_error_messages(name, args):
    t, j = getattr(t_errors, name)(*args), getattr(j_errors, name)(*args)
    assert isinstance(t, t_errors.Error) and str(t) == str(j)


@pytest.mark.parametrize("pair", ["constants", "fingerprint.constants"])
def test_constants(pair):
    t, j = {"constants": (t_constants, j_constants),
            "fingerprint.constants": (t_fconstants, j_fconstants)}[pair]
    names = [n for n in dir(j) if n.isupper()]
    assert names and names == [n for n in dir(t) if n.isupper()]
    for n in names:
        a, b = getattr(t, n), getattr(j, n)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), n
        else:
            assert a == b, n
    if pair == "fingerprint.constants":
        assert np.array_equal(t.hamming_window(), j.hamming_window())
        for fn in ("chroma_bin_ranges", "classifier_window_matrix"):
            for a, b in zip(getattr(t, fn)(), getattr(j, fn)()):
                assert np.array_equal(a, b), fn


def test_size_bucket():
    for x in list(range(0, 5000, 7)) + [2**20 + 1, 10**7]:
        for minimum in (256, 512):
            assert t_shapes.size_bucket(x, minimum) == j_shapes.size_bucket(
                x, minimum)


# -- search oracle -------------------------------------------------------------


def _planted(seed, n, m, run, flips):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    dst[::53] = src[::53][: len(dst[::53])]  # scattered single-cell matches
    dst[17 : 17 + run] = src[40 : 40 + run]
    for k in range(flips):
        dst[17 + (k * 7) % run] ^= np.uint32(1) << np.uint32(k % 32)
    return src, dst


@pytest.mark.parametrize("seed,threshold,is_opening,min_secs", [
    (1, 10, True, 20), (2, 0, True, 5), (3, 10, False, 20), (4, 32, True, 2),
    (5, 4, False, 1),
])
def test_longest_common_hash_match(seed, threshold, is_opening, min_secs):
    src, dst = _planted(seed, 260, 230, 120, 9)
    src_ts = (2600090703 + np.arange(len(src)) * STEP).astype(np.int64)
    dst_ts = (2600090703 + np.arange(len(dst)) * STEP).astype(np.int64)
    out = []
    for oracle, dur in ((t_oracle, t_duration), (j_oracle, j_duration)):
        D = dur.Duration
        out.append(_canon(oracle.longest_common_hash_match(
            src, src_ts, dst, dst_ts, D.from_millis(300), D.from_millis(301),
            is_opening, threshold, D.from_secs(min_secs), D.from_secs(min_secs),
        )))
    assert out[0] == out[1]
    assert len(out[0]) > 0


@pytest.mark.parametrize("seed,n,n_keys", [(0, 1, 3), (1, 50, 4), (2, 700, 30),
                                            (3, 257, 1000)])
def test_heap_order_popcount_and_simhash(seed, n, n_keys):
    rng = np.random.default_rng(seed)
    keys = [tuple(k) for k in rng.integers(0, n_keys, size=(n, 2)).tolist()]
    assert t_oracle.binary_heap_perm(keys) == j_oracle.binary_heap_perm(keys)
    h = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    assert np.array_equal(t_oracle.popcount_u32(h), j_oracle.popcount_u32(h))
    starts = rng.integers(0, n, size=20)
    ends = np.minimum(starts + rng.integers(0, 40, size=20), n - 1)
    assert np.array_equal(t_oracle.simhash32_batch(h, starts, ends),
                          j_oracle.simhash32_batch(h, starts, ends))
    assert np.array_equal(t_oracle.simhash_prefix(h), j_oracle.simhash_prefix(h))


# -- fingerprint ------------------------------------------------------------------


def _pcm(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return (rng.standard_normal(n) * 6000).astype(np.int16)
    x = j_testing._music_like(rng, n, 11025)
    return np.clip(x * 9000, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("kind,secs", [("music", 9.0), ("noise", 6.5),
                                       ("music", 0.2)])
def test_fingerprint_numpy(kind, secs):
    mono = _pcm(int(secs * 10), int(secs * 11025), kind)
    got = t_numpy_impl.fingerprint_numpy(mono)
    want = j_numpy_impl.fingerprint_numpy(mono)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for lo, hi in ((0, 3), (5, 20), (max(0, len(want) - 4), len(want))):
        assert np.array_equal(t_numpy_impl.fingerprint_numpy_window(mono, lo, hi),
                              j_numpy_impl.fingerprint_numpy_window(mono, lo, hi))
    flagged = np.flatnonzero(np.random.default_rng(1).random(200) < 0.05)
    assert t_numpy_impl.merge_flag_ranges(flagged) == \
        j_numpy_impl.merge_flag_ranges(flagged)
    stereo = np.stack([mono, mono[::-1]], axis=1).reshape(-1)
    assert np.array_equal(t_numpy_impl.downmix_stereo_i16(stereo),
                          j_numpy_impl.downmix_stereo_i16(stereo))


@pytest.mark.parametrize("kind,secs", [("music", 8.0), ("noise", 5.5),
                                       ("music", 0.15)])
def test_classifier_values_oracle(kind, secs):
    mono = _pcm(int(secs * 30), int(secs * 11025), kind)
    got = t_numpy_impl.classifier_values_oracle(mono)
    want = j_numpy_impl.classifier_values_oracle(mono)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert len(want[0]) > 0 or secs < 1


@pytest.mark.parametrize("kind,secs", [("music", 7.0), ("noise", 3.5),
                                       ("music", 0.1)])
def test_fingerprint_numpy_stereo(kind, secs):
    mono = _pcm(int(secs * 20), int(secs * 11025), kind)
    stereo = np.stack([mono, _pcm(3, len(mono), "noise")], axis=1).reshape(-1)
    got = t_numpy_impl.fingerprint_numpy_stereo(stereo)
    want = j_numpy_impl.fingerprint_numpy_stereo(stereo)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("channels,secs", [(1, 6.0), (2, 4.5), (2, 0.05)])
def test_chromaprint_oracle(channels, secs):
    assert t_fp_oracle.available() == j_fp_oracle.available()
    assert t_fp_oracle.ALGORITHM_TEST2 == j_fp_oracle.ALGORITHM_TEST2
    assert t_fp_oracle._LIB_CANDIDATES == j_fp_oracle._LIB_CANDIDATES
    if not t_fp_oracle.available():
        pytest.skip("libchromaprint not installed")
    pcm = _pcm(channels, int(secs * 11025) * channels, "music")
    got = t_fp_oracle.fingerprint_oracle(pcm, channels)
    want = j_fp_oracle.fingerprint_oracle(pcm, channels)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    t, j = t_fp_oracle.ChromaprintOracle(), j_fp_oracle.ChromaprintOracle()
    half = len(pcm) // (2 * channels) * channels  # on a frame boundary
    for ctx in (t, j):
        ctx.start(11025, channels)
        ctx.feed(pcm[:half])
        ctx.feed(pcm[half:])
        ctx.finish()
    assert np.array_equal(t.get_raw_fingerprint(), j.get_raw_fingerprint())
    t.close()
    j.close()


@pytest.mark.parametrize("name,rate,channels,dtype", [
    ("a.wav", 16000, 1, np.int16), ("b.wav", 44100, 2, np.int16),
    ("c.wav", 22050, 2, np.float32), ("d.pcm", 16000, 1, np.int16),
])
def test_host_resampler(tmp_path, name, rate, channels, dtype):
    pcm = _pcm(rate, int(rate * 2.5) * channels, "music")
    if dtype == np.float32:
        pcm = (pcm / 32768.0).astype(np.float32)
    got = t_ingest.resample_pcm_to_stereo(pcm, rate, channels)
    want = j_ingest.resample_pcm_to_stereo(pcm, rate, channels)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    path = tmp_path / name
    if name.endswith(".wav"):  # PCM16 (format 1) or float32 (format 3)
        data = pcm.astype(pcm.dtype.newbyteorder("<")).tobytes()
        fmt, width = (1, 2) if dtype == np.int16 else (3, 4)
        path.write_bytes(
            b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, fmt, channels, rate,
                          rate * channels * width, channels * width, 8 * width)
            + b"data" + struct.pack("<I", len(data)) + data)
    else:
        pcm.astype("<i2").tofile(path)
    (t_pcm, t_dur), (j_pcm, j_dur) = (t_ingest.load_pcm_as_chromaprint_input(path),
                                      j_ingest.load_pcm_as_chromaprint_input(path))
    assert t_dur == j_dur and len(t_pcm) > 0
    assert t_pcm.dtype == j_pcm.dtype and np.array_equal(t_pcm, j_pcm)


@pytest.mark.parametrize("design", [(28, 9.0), (3, 5.65), (5, 7.0)])
def test_halfband_taps(design):
    (tq, tc), (jq, jc) = (t_decimate._halfband_q14(*design),
                          j_decimate._halfband_q14(*design))
    assert tq.dtype == jq.dtype and np.array_equal(tq, jq) and tc == jc
    assert (t_decimate._HB_MAIN, t_decimate._HB_RELAXED) == (
        j_decimate._HB_MAIN, j_decimate._HB_RELAXED)
    for rate in (8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000, 96000):
        assert t_decimate.decimation_factor(rate) == \
            j_decimate.decimation_factor(rate)


@pytest.mark.parametrize("in_rate,channels", [(16000, 1), (44100, 2),
                                              (48000, 1), (11025, 2)])
def test_ingest_oracle_helpers(in_rate, channels):
    dec = j_decimate.decimation_factor(in_rate)
    dec = dec if dec in (2, 4) else 1
    seg = _pcm(in_rate + channels, in_rate * channels * 3, "noise")
    n_valid = int(len(seg) * 0.7) // channels * channels
    in_len_mid = len(seg) // channels // dec + 500
    args = (seg, n_valid, channels, dec, in_len_mid)
    a = t_ingest_oracle._ingest_prepare_mid(*args)
    b = j_ingest_oracle._ingest_prepare_mid(*args)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for lo, hi in ((-100, 400), (1000, 5000), (len(b) - 300, len(b) + 300)):
        assert np.array_equal(t_ingest_oracle._prepare_mid_window(*args, lo, hi),
                              j_ingest_oracle._prepare_mid_window(*args, lo, hi))
    x = seg[: len(seg) // channels * channels].reshape(-1, channels)
    for design in ((28, 9.0), (3, 5.65)):
        q = j_decimate._halfband_q14(*design)
        assert np.array_equal(t_ingest_oracle.decimate2_hb_np(x, *q),
                              j_ingest_oracle.decimate2_hb_np(x, *q))
    mono = b[:50000].astype(np.float32)
    assert np.array_equal(t_ingest_oracle._fingerprint_window_f32(mono, 12),
                          j_ingest_oracle._fingerprint_window_f32(mono, 12))
    assert t_ingest_oracle._RESCAN_EXTRA == j_ingest_oracle._RESCAN_EXTRA


# -- analyzer timestamps -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["samples", "ms"])
@pytest.mark.parametrize("hd_ms,seek_ns", [(300, None), (124, 900_123_456_789),
                                           (1000, 5)])
def test_hashes_with_timestamps(monkeypatch, mode, hd_ms, seek_ns):
    monkeypatch.setenv("NEEDLE_TPU_TS_MODE", mode)
    raw = np.random.default_rng(hd_ms).integers(0, 2**32, 3000, dtype=np.uint32)
    out = []
    for mod, dur in ((t_analyzer, t_duration), (j_analyzer, j_duration)):
        D = dur.Duration
        seek = None if seek_ns is None else D.from_nanos(seek_ns)
        h, ts = mod.Analyzer._hashes_with_timestamps(raw, D.from_millis(hd_ms),
                                                     seek)
        out.append((h.tolist(), ts.tolist(),
                    _canon(mod.chromaprint_delay_item())))
    assert out[0] == out[1]


# -- synthetic seasons ---------------------------------------------------------


@pytest.mark.parametrize("ending_secs,rate", [(0.0, 16000), (8.0, 11025)])
def test_make_synthetic_season(tmp_path, ending_secs, rate):
    kw = dict(num_episodes=2, episode_secs=20.0, opening_secs=6.0,
              opening_offset_range=(1.0, 3.0), ending_secs=ending_secs,
              rate=rate, seed=77)
    tp, t_op, t_end = t_testing.make_synthetic_season(tmp_path / "t", **kw)
    jp, j_op, j_end = j_testing.make_synthetic_season(tmp_path / "j", **kw)
    assert (t_op, t_end) == (j_op, j_end)
    assert [p.name for p in tp] == [p.name for p in jp]
    for a, b in zip(tp, jp):
        assert a.read_bytes() == b.read_bytes()


# -- comparator ------------------------------------------------------------------


def _library(seed, with_endings):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 2**32, size=90, dtype=np.uint32)
    shared_end = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    specs = []
    for e in range(4):
        h = rng.integers(0, 2**32, size=300 + 30 * e, dtype=np.uint32)
        h[20 + 9 * e : 110 + 9 * e] = shared
        h[25 + 9 * e] ^= np.uint32(0x101)
        end = rng.integers(0, 2**32, size=(220 if with_endings else 0),
                           dtype=np.uint32)
        if with_endings:
            end[50 - 4 * e : 150 - 4 * e] = shared_end
        ot = (2600090703 + np.arange(len(h)) * STEP).astype(np.int64)
        et = (900_000_000_000 + np.arange(len(end)) * STEP).astype(np.int64)
        specs.append((h, ot, end, et, f"{e:032x}"))
    return specs


@pytest.mark.parametrize("with_endings,threshold,padding_s,min_secs", [
    (False, 10, 0.0, 20), (True, 10, 1.5, 20), (True, 0, 0.0, 5),
    (False, 6, 0.25, 10),
])
def test_comparator_numpy_engine(with_endings, threshold, padding_s, min_secs):
    specs = _library(threshold + min_secs, with_endings)
    out = []
    for cmp_mod, data, dur in ((t_comparator, t_data, t_duration),
                               (j_comparator, j_data, j_duration)):
        D = dur.Duration
        fhs = [data.FrameHashes(h, ot, e, et, D.from_millis(300), md5)
               for h, ot, e, et, md5 in specs]
        cmp = (
            cmp_mod.Comparator([f"e{k}.mkv" for k in range(4)], engine="numpy")
            .with_include_endings(with_endings)
            .with_hash_match_threshold(threshold)
            .with_min_opening_duration(D.from_secs(min_secs))
            .with_min_ending_duration(D.from_secs(min_secs))
            .with_time_padding(D.from_secs_f32(np.float32(padding_s)))
        )
        infos = cmp.search_pair_infos(fhs, cmp.pair_order(4), threading=False)
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            res = cmp.run_with_frame_hashes(fhs, True, False, False, False)
        out.append((
            _canon([[i.src_openings, i.dst_openings, i.src_endings,
                     i.dst_endings] for i in infos]),
            _canon([(r.opening, r.ending) for r in res]),
            stdout.getvalue(),
        ))
    assert out[0] == out[1]
    if threshold:
        assert any(op is not None for op, _ in out[0][1])


# -- CLI -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def analyzed_season(tmp_path_factory):
    """A 4-episode season analyzed by the port's CLI on the CPU."""
    from needle_tpu_torch.cli import main

    season = tmp_path_factory.mktemp("season")
    t_testing.make_synthetic_season(
        season, num_episodes=4, episode_secs=60.0, opening_secs=20.0,
        opening_offset_range=(2.0, 8.0), ending_secs=12.0, seed=4242,
    )
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["analyze", "--device", "cpu", "--include-endings",
                     str(season)]) == 0
    return season


@pytest.mark.parametrize("flags", [
    ["--include-endings", "--write-skip-files"],
    ["--hash-match-threshold", "8", "--time-padding", "1.5"],
    ["--min-opening-duration", "5", "--no-threading"],
])
def test_cli_search_stdout(tmp_path, monkeypatch, analyzed_season, flags):
    from needle_tpu.cli import main as jax_main
    from needle_tpu_torch.cli import main as torch_main

    monkeypatch.setenv("NEEDLE_TPU_ALLOW_AUDIO", "1")
    outs = {}
    for name, main, extra in (("torch", torch_main, ["--device", "cpu"]),
                              ("jax", jax_main, [])):
        season = tmp_path / name
        shutil.copytree(analyzed_season, season)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["search", *flags, *extra, str(season)]) == 0
        skips = {p.name: p.read_bytes()
                 for p in sorted(season.glob("*.needle.skip.json"))}
        outs[name] = (buf.getvalue().replace(str(season), "<season>"), skips)
    assert outs["torch"] == outs["jax"]
    assert "* Opening - \"" in outs["torch"][0]
    assert bool(outs["torch"][1]) == ("--write-skip-files" in flags)
