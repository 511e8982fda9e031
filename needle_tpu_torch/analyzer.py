"""Analyzer on PyTorch: per-video decode -> fingerprint -> FrameHashes.

Mirrors needle/src/audio/analyzer.rs, as needle_tpu/analyzer.py does; this
is the port's own copy of it. The backend picks where the fingerprint math
runs:

  * "auto" (default) — on a torch device ('cuda' or 'cpu'), episodes
    batched, by the two routes below.
  * "numpy" — the NumPy pipeline (`fingerprint_numpy_stereo`) on the host.
  * "chromaprint" — ctypes to a system libchromaprint
    (`fingerprint.oracle`), bit-exact with that build; it raises where the
    library is missing, with no fallback.

needle_tpu's "jax" backend has no counterpart and is refused. "numpy" and
"chromaprint" take needle_tpu's host route for every file: decode (WAV and
raw PCM through the native resampler too) to 11025 Hz stereo, fingerprint
one video per thread. "auto" sends every episode's windows through one
`fingerprint.torch_impl.IngestDispatcher` per source format, which batches
them into lane chunks, runs decimation, downmix, resampling and the
fingerprint on the device and rescans borderline hashes exactly on the
host:

  * Raw-PCM sources (WAV, .pcm, .raw) are read as memmaps at their own
    rate and channel count.
  * Compressed media (.mkv, .mp4, ...) is decoded on the host by the
    native FFmpeg layer (`ingest`) to 11025 Hz stereo and downmixed to
    mono: lanes of the 11025 Hz mono dispatcher.

Timestamp math replicates the reference exactly (analyzer.rs:286-318):
  delay = 28666 samples, item duration = 1365 samples (chromaprint TEST2),
  converted to Durations at full precision; ts_i = delay + item.mul_f32(i),
  stepping raw hash indices by hash_duration.as_millis()/item.as_millis();
  ending hashes additionally get seek_to added, where
  seek_to = stream_duration.mul_f32(1 - ending_search_percentage).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import constants, ingest
from .data import FrameHashes, frame_hash_data_path
from .duration import Duration
from .errors import AnalyzerMissingPaths
from .fingerprint.constants import DELAY_SAMPLES, ITEM_DURATION_SAMPLES, SAMPLE_RATE
from .fingerprint.numpy_impl import downmix_stereo_i16
from .fingerprint.torch_impl import IngestDispatcher
from .util import compute_header_md5sum

# chromaprint-rust converts chromaprint's delay/item counters to Durations,
# and which conversion the crate uses cannot be confirmed offline, so both
# are implemented, switchable with NEEDLE_TPU_TS_MODE (as in needle_tpu):
#
#   * "samples" (default): Duration from the sample counters at full f64
#     precision — delay = 28666/11025 s, item = 1365/11025 s.
#   * "ms": Duration::from_millis of the C API's millisecond accessors,
#     which truncate (samples * 1000 / 11025 in integer math): delay =
#     2600 ms, item = 123 ms.
#
# step_by (analyzer.rs:293-296) divides truncated as_millis() values and is
# IDENTICAL in both modes (123 ms). `.needle.dat` caches are keyed by
# header MD5 only (reference semantics), so files written under one mode
# are NOT invalidated by switching modes — re-analyze with force=True /
# --force after changing NEEDLE_TPU_TS_MODE.
_TS_MODES = ("samples", "ms")


def _ts_mode() -> str:
    v = os.environ.get("NEEDLE_TPU_TS_MODE", "samples")
    if v not in _TS_MODES:
        raise ValueError(
            f"NEEDLE_TPU_TS_MODE must be one of {_TS_MODES}, got {v!r}"
        )
    return v


def chromaprint_delay_item() -> Tuple[Duration, Duration]:
    """(hash delay, item duration) under the active NEEDLE_TPU_TS_MODE."""
    if _ts_mode() == "ms":
        return (
            Duration.from_millis(DELAY_SAMPLES * 1000 // SAMPLE_RATE),
            Duration.from_millis(ITEM_DURATION_SAMPLES * 1000 // SAMPLE_RATE),
        )
    return CHROMAPRINT_DELAY, CHROMAPRINT_ITEM_DURATION


# Module-level constants give the default ("samples") values; timestamp
# assembly goes through chromaprint_delay_item() so the mode is switchable.
CHROMAPRINT_DELAY = Duration.from_secs_f64(DELAY_SAMPLES / SAMPLE_RATE)
CHROMAPRINT_ITEM_DURATION = Duration.from_secs_f64(ITEM_DURATION_SAMPLES / SAMPLE_RATE)


def _fingerprint_backend(name: str):
    """Resolve a host backend name to fn(stereo_interleaved_i16) -> uint32
    array; None for "auto", the device routes."""
    if name == "numpy":
        from .fingerprint.numpy_impl import fingerprint_numpy_stereo

        return fingerprint_numpy_stereo
    if name == "chromaprint":
        from .fingerprint.oracle import fingerprint_oracle

        return lambda pcm: fingerprint_oracle(pcm, channels=2)
    if name == "auto":
        return None
    if name == "jax":
        raise ValueError(
            "the jax backend is needle_tpu's; needle_tpu_torch fingerprints "
            "with 'auto' on a torch device, or 'numpy' or 'chromaprint'"
        )
    raise ValueError(f"unknown fingerprint backend: {name}")


class Analyzer:
    """Analyzes videos into FrameHashes (analyzer.rs:85-455) on a torch
    device ('cuda' or 'cpu'), or on the host with backend "numpy" or
    "chromaprint"."""

    def __init__(self, videos: Sequence = (), device: str = "cuda",
                 backend: str = "auto"):
        _fingerprint_backend(backend)  # refuses "jax" and unknown names
        self.videos: List[Path] = [Path(v) for v in videos]
        self.opening_search_percentage: float = (
            constants.DEFAULT_OPENING_SEARCH_PERCENTAGE
        )
        self.ending_search_percentage: float = (
            constants.DEFAULT_ENDING_SEARCH_PERCENTAGE
        )
        self.include_endings: bool = False
        self.threaded_decoding: bool = False
        self.force: bool = False
        self.device = device
        self.backend_name = backend

    # -- builder API (analyzer.rs:108-151) ------------------------------------

    @classmethod
    def from_files(
        cls, videos: Sequence, threaded_decoding: bool = False, force: bool = False, **kw
    ) -> "Analyzer":
        a = cls(videos, **kw)
        a.threaded_decoding = threaded_decoding
        a.force = force
        return a

    def with_opening_search_percentage(self, v: float) -> "Analyzer":
        self.opening_search_percentage = float(v)
        return self

    def with_ending_search_percentage(self, v: float) -> "Analyzer":
        self.ending_search_percentage = float(v)
        return self

    def with_include_endings(self, v: bool) -> "Analyzer":
        self.include_endings = bool(v)
        return self

    def with_threaded_decoding(self, v: bool) -> "Analyzer":
        self.threaded_decoding = bool(v)
        return self

    def with_force(self, v: bool) -> "Analyzer":
        self.force = bool(v)
        return self

    # -- host decode ------------------------------------------------------------

    def _decode_segments(
        self, path: Path
    ) -> Tuple[np.ndarray, Optional[np.ndarray], Duration, Optional[Duration]]:
        """Decode the opening window and (optionally) the ending window.

        Returns (opening_pcm, ending_pcm, stream_duration, ending_seek_to),
        with PCM as S16 interleaved stereo @ 11025 Hz.
        """
        if ingest.is_pcm_file(path):
            pcm, duration_secs = ingest.load_pcm_as_chromaprint_input(path)
            stream_duration = Duration.from_secs_f64(duration_secs)
            opening_duration = stream_duration.mul_f32(
                np.float32(self.opening_search_percentage)
            )
            n_open = int(opening_duration.as_secs_f64() * SAMPLE_RATE) * 2
            opening_pcm = pcm[:n_open]
            ending_pcm, seek_to = None, None
            if self.include_endings:
                seek_to = stream_duration.mul_f32(
                    np.float32(1.0) - np.float32(self.ending_search_percentage)
                )
                # ms-truncated like the reference's seek (audio/util.rs:36-38)
                # and the device-ingest path
                n_skip = int((seek_to.as_millis() / 1000.0) * SAMPLE_RATE) * 2
                ending_pcm = pcm[n_skip:]
            return opening_pcm, ending_pcm, stream_duration, seek_to

        # First probe duration (cheap open), mirroring analyzer.rs:362-374.
        duration_secs = ingest.stream_duration_secs(path)
        return self._decode_segments_av(path, duration_secs)

    def _decode_segments_av(self, path: Path, duration_secs: float):
        stream_duration = Duration.from_secs_f64(duration_secs)

        opening_duration = stream_duration.mul_f32(
            np.float32(self.opening_search_percentage)
        )
        opening_pcm, _ = ingest.decode_audio(
            path,
            seek_to_secs=None,
            duration_limit_secs=opening_duration.as_secs_f64(),
            sample_rate=SAMPLE_RATE,
            threaded=self.threaded_decoding,
        )
        ending_pcm, seek_to = None, None
        if self.include_endings:
            seek_to = stream_duration.mul_f32(
                np.float32(1.0) - np.float32(self.ending_search_percentage)
            )
            # The reference seeks using ms-truncated timestamps
            # (audio/util.rs:36-38).
            ending_pcm, _ = ingest.decode_audio(
                path,
                seek_to_secs=seek_to.as_millis() / 1000.0,
                duration_limit_secs=None,
                sample_rate=SAMPLE_RATE,
                threaded=self.threaded_decoding,
            )
        return opening_pcm, ending_pcm, stream_duration, seek_to

    # -- device ingest (raw PCM -> device decimate/resample/fingerprint) -------

    def _use_device_ingest(self, path) -> bool:
        return ingest.is_pcm_file(path)

    def _raw_segments(
        self, path: Path
    ) -> Tuple[np.ndarray, int, Optional[np.ndarray], Optional[int],
               int, int, Optional[Duration]]:
        """Source-rate opening/ending windows of a PCM file, with the window
        semantics of `_decode_segments`: (opening_seg, opening_n_valid,
        ending_seg, ending_n_valid, rate, channels, seek_to). The opening
        segment is the whole memmap with n_valid = the window length; the
        ingest zeroes what lies past it."""
        from .tracing import span

        with span("ingest.read_raw"):
            samples, rate, channels, duration_secs = ingest.read_pcm_mmap(path)
        stream_duration = Duration.from_secs_f64(duration_secs)
        opening_duration = stream_duration.mul_f32(
            np.float32(self.opening_search_percentage)
        )
        n_open = int(opening_duration.as_secs_f64() * rate) * channels
        ending_seg, ending_nv, seek_to = None, None, None
        if self.include_endings:
            seek_to = stream_duration.mul_f32(
                np.float32(1.0) - np.float32(self.ending_search_percentage)
            )
            # ms-truncated like the reference's seek (audio/util.rs:36-38)
            n_skip = int((seek_to.as_millis() / 1000.0) * rate) * channels
            ending_seg = samples[n_skip:]
            ending_nv = len(ending_seg)
        return (samples, n_open, ending_seg, ending_nv, rate, channels,
                seek_to)

    # -- hash assembly (analyzer.rs:286-318) -----------------------------------

    # Timestamp tables are identical across episodes (ts_i depends only on the
    # raw index i); cache them per (step_by, mode).
    _ts_table_cache: dict = {}

    @classmethod
    def _ts_table(cls, step_by: int, count: int) -> np.ndarray:
        """int64 nanos of delay + item.mul_f32(i) for i = 0, step, 2*step..."""
        delay, item = chromaprint_delay_item()
        key = (step_by, _ts_mode())
        cached = cls._ts_table_cache.get(key)
        if cached is None or len(cached) < count:
            want = max(count, 2 * len(cached) if cached is not None else count, 1024)
            idx = np.arange(0, want * step_by, step_by, dtype=np.int64)
            item_f32 = item.as_secs_f32()
            prods = np.float32(idx.astype(np.float32) * item_f32)
            # Duration::from_secs_f32: exact f32 value -> nanos, half-even,
            # in exact Fraction math
            cached = np.array(
                [round(Fraction(float(p)) * 10**9) for p in prods], dtype=np.int64
            )
            cached += delay.total_nanos()
            cls._ts_table_cache[key] = cached
        return cached[:count]

    @staticmethod
    def _hashes_with_timestamps(
        raw_hashes: np.ndarray,
        hash_duration: Optional[Duration],
        seek_to: Optional[Duration],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Select every step_by-th raw hash and attach reference-exact
        timestamps. Returns (uint32 hashes, int64 ts_nanos)."""
        if hash_duration is not None:
            item = chromaprint_delay_item()[1]
            step_by = hash_duration.as_millis() // item.as_millis()
            if step_by == 0:
                # Rust Iterator::step_by(0) panics.
                raise ValueError("hash_duration shorter than chromaprint item duration")
        else:
            step_by = 1
        idx = np.arange(0, len(raw_hashes), step_by, dtype=np.int64)
        hashes = np.asarray(raw_hashes, dtype=np.uint32)[idx]
        ts = Analyzer._ts_table(step_by, len(idx)).copy()
        if seek_to is not None:
            ts += seek_to.total_nanos()
        return hashes, ts

    # -- runs --------------------------------------------------------------------

    def _cached(self, path: Path, md5: str) -> Optional[FrameHashes]:
        """The video's `.needle.dat` when it holds this header md5 and
        force is off; None when the video must be analyzed."""
        fhp = frame_hash_data_path(path)
        if self.force or not fhp.exists():
            return None
        try:
            data = FrameHashes.from_path(fhp)
        except Exception:
            return None
        if data.md5() != md5:
            return None
        print(f"Skipping analysis for {path}...")
        return data

    def run_single(
        self, path, hash_duration: Duration, persist: bool
    ) -> FrameHashes:
        """analyzer.rs:326-420: on the host backend's route, or through the
        same batched program as `run`."""
        fp = _fingerprint_backend(self.backend_name)
        if fp is not None:
            return self._run_single_host(Path(path), fp, hash_duration, persist)
        return self._run_batched_block(
            [Path(path)], hash_duration, persist, threading=False
        )[0]

    def _run_single_host(
        self, path: Path, fp, hash_duration: Duration, persist: bool
    ) -> FrameHashes:
        """needle_tpu's host route: decode to 11025 Hz stereo, then `fp`."""
        md5 = compute_header_md5sum(path)
        cached = self._cached(path, md5)
        if cached is not None:
            return cached

        opening_pcm, ending_pcm, _, seek_to = self._decode_segments(path)
        oh, ot = self._hashes_with_timestamps(fp(opening_pcm), hash_duration, None)
        if ending_pcm is not None:
            eh, et = self._hashes_with_timestamps(
                fp(ending_pcm), hash_duration, seek_to
            )
        else:
            eh = np.zeros(0, np.uint32)
            et = np.zeros(0, np.int64)

        frame_hashes = FrameHashes(oh, ot, eh, et, hash_duration, md5)
        if persist:
            frame_hashes.save(frame_hash_data_path(path))
        return frame_hashes

    def run(
        self, hash_duration: Duration, persist: bool, threading: bool = True
    ) -> List[FrameHashes]:
        """analyzer.rs:425-455. On "auto" every episode's windows are
        fingerprinted as batched device dispatches, in streaming waves of
        STREAM_BLOCK; a host backend takes one video per thread."""
        from .tracing import carry, pass_span

        if len(self.videos) == 0:
            raise AnalyzerMissingPaths()
        if isinstance(hash_duration, (int, float)):
            hash_duration = Duration.from_secs_f32(np.float32(hash_duration))
        with pass_span("analyze", videos=len(self.videos)):
            if _fingerprint_backend(self.backend_name) is None:
                return self._run_batched(hash_duration, persist, threading)
            if threading and len(self.videos) > 1:
                with ThreadPoolExecutor() as pool:
                    return list(
                        pool.map(
                            carry(lambda p: self.run_single(
                                p, hash_duration, persist)),
                            self.videos,
                        )
                    )
            return [self.run_single(p, hash_duration, persist)
                    for p in self.videos]

    # Episodes per streaming wave: bounds host PCM memory for 1000+ episode
    # libraries.
    STREAM_BLOCK = 64

    def _run_batched(
        self, hash_duration: Duration, persist: bool, threading: bool
    ) -> List[FrameHashes]:
        """Batched analyze in streaming waves of STREAM_BLOCK episodes."""
        videos = [Path(p) for p in self.videos]
        results: List[FrameHashes] = []
        for w0 in range(0, len(videos), self.STREAM_BLOCK):
            results.extend(
                self._run_batched_block(
                    videos[w0 : w0 + self.STREAM_BLOCK],
                    hash_duration,
                    persist,
                    threading,
                )
            )
        return results

    def _run_batched_block(
        self, videos: List[Path], hash_duration: Duration, persist: bool,
        threading: bool,
    ) -> List[FrameHashes]:
        """One wave: threaded reads and decodes -> lane-chunk dispatches as
        they fill, each chunk's borderline hashes rescanned on a worker
        thread meanwhile (inline at the end without `threading`) ->
        assembly/persist. Cache semantics identical to needle_tpu's. The
        span `analyze.read_wait` is the main thread's wait for each
        episode's read (the read itself without `threading`); a raw-PCM
        read maps the file, whose bytes are read where the lanes are
        assembled (`ingest.lane_copy`)."""
        from .tracing import carry, span

        def prepare(path):
            """("cached", FrameHashes) or (md5, seek_to, has_ending,
            (opening segment, its n_valid, ending segment or None, its
            n_valid, rate, channels)): a raw-PCM file's windows at its own
            rate, or compressed media's decoded and downmixed to 11025 Hz
            mono (n_valid None: all of it)."""
            md5 = compute_header_md5sum(path)
            cached = self._cached(path, md5)
            if cached is not None:
                return ("cached", cached)
            if self._use_device_ingest(path):
                segs = self._raw_segments(path)
                return (md5, segs[6], segs[2] is not None, segs[:6])
            opening_pcm, ending_pcm, _, seek_to = self._decode_segments(path)
            ending = (None if ending_pcm is None
                      else downmix_stereo_i16(ending_pcm))
            return (md5, seek_to, ending is not None,
                    (downmix_stereo_i16(opening_pcm), None, ending, None,
                     SAMPLE_RATE, 1))

        dispatchers: dict = {}  # (rate, channels) -> IngestDispatcher
        prepped: List[tuple] = []

        def consume(vi: int, item: tuple) -> None:
            # each episode's windows join the device lane chunks as soon as
            # it is read, so reads overlap the dispatches
            prepped.append(item)
            if item[0] == "cached":
                return
            op_seg, op_nv, en_seg, en_nv, rate, channels = item[3]
            d = dispatchers.get((rate, channels))
            if d is None:
                d = dispatchers[(rate, channels)] = IngestDispatcher(
                    rate, channels, self.device, threading
                )
            d.add((vi, "opening"), op_seg, op_nv)
            if en_seg is not None:
                d.add((vi, "ending"), en_seg, en_nv)

        with span("analyze.decode", videos=len(videos)):
            if threading and len(videos) > 1:
                workers = max(1, min(4, os.cpu_count() or 4))
                with ThreadPoolExecutor(
                        max_workers=workers,
                        thread_name_prefix="needle-read") as pool:
                    items = pool.map(carry(prepare), videos)
                    for vi in range(len(videos)):
                        with span("analyze.read_wait"):
                            item = next(items)
                        consume(vi, item)
            else:
                for vi, path in enumerate(videos):
                    with span("analyze.read_wait"):
                        item = prepare(path)
                    consume(vi, item)

        hashes_by_ref = {}
        with span(
            "analyze.fingerprint",
            lanes=sum(len(d._out_lens) for d in dispatchers.values()),
        ):
            for d in dispatchers.values():
                hashes_by_ref.update(d.finish())

        results: List[FrameHashes] = []
        with span("analyze.assemble"):
            for vi, (path, item) in enumerate(zip(videos, prepped)):
                if item[0] == "cached":
                    results.append(item[1])
                    continue
                md5, seek_to, has_ending = item[:3]
                oh, ot = self._hashes_with_timestamps(
                    hashes_by_ref[(vi, "opening")], hash_duration, None
                )
                if has_ending:
                    eh, et = self._hashes_with_timestamps(
                        hashes_by_ref[(vi, "ending")], hash_duration, seek_to
                    )
                else:
                    eh = np.zeros(0, np.uint32)
                    et = np.zeros(0, np.int64)
                fh = FrameHashes(oh, ot, eh, et, hash_duration, md5)
                if persist:
                    fh.save(frame_hash_data_path(path))
                results.append(fh)
        return results
