"""Analyzer on PyTorch: needle_tpu's Analyzer with the torch fingerprint
paths.

Raw-PCM sources (WAV, .pcm, .raw) are read as memmaps at their own rate
and go through `fingerprint.torch_impl.IngestDispatcher` on the chosen
device: decimation, downmix, resampling and fingerprinting all run there.
Compressed media (.mkv, .mp4, ...) is decoded on the host by the base
class's native FFmpeg decode to 11025 Hz stereo, downmixed to mono, and
fingerprinted by `fingerprint.torch_impl.fingerprint_batch` on the device.
On both routes borderline hashes are rescanned exactly on the host.
Timestamps, caching and `.needle.dat` output are the base class's,
unchanged.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from needle_tpu import ingest
from needle_tpu.analyzer import Analyzer as _BaseAnalyzer
from needle_tpu.data import FrameHashes, frame_hash_data_path
from needle_tpu.duration import Duration
from needle_tpu.errors import AnalyzerMissingPaths
from needle_tpu.fingerprint.numpy_impl import downmix_stereo_i16
from needle_tpu.util import compute_header_md5sum

from .fingerprint.torch_impl import IngestDispatcher, fingerprint_batch


class Analyzer(_BaseAnalyzer):
    """Analyzes episodes into FrameHashes on a torch device ('cuda' or
    'cpu')."""

    def __init__(self, videos: Sequence = (), device: str = "cuda"):
        super().__init__(videos, backend="torch")
        self.device = device

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
        from needle_tpu.tracing import span

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

    def run_single(
        self, path, hash_duration: Duration, persist: bool
    ) -> FrameHashes:
        """analyzer.rs:326-420, through the same batched program."""
        return self._run_batched_block(
            [Path(path)], hash_duration, persist, threading=False
        )[0]

    def run(
        self, hash_duration: Duration, persist: bool, threading: bool = True
    ) -> List[FrameHashes]:
        """analyzer.rs:425-455: every episode's windows are fingerprinted as
        batched device dispatches, in streaming waves of STREAM_BLOCK."""
        if len(self.videos) == 0:
            raise AnalyzerMissingPaths()
        if isinstance(hash_duration, (int, float)):
            hash_duration = Duration.from_secs_f32(np.float32(hash_duration))
        return self._run_batched(hash_duration, persist, threading)

    def _run_batched_block(
        self, videos: List[Path], hash_duration: Duration, persist: bool,
        threading: bool,
    ) -> List[FrameHashes]:
        """One wave: threaded reads and decodes -> lane-chunk dispatches as
        they fill -> assembly/persist. Cache semantics identical to
        needle_tpu's."""
        from needle_tpu.tracing import span

        def prepare(path):
            """("cached", FrameHashes) or (md5, seek_to, has_ending, "raw",
            raw segments) or (md5, seek_to, has_ending, "decoded", (opening
            mono, ending mono or None))."""
            md5 = compute_header_md5sum(path)
            fhp = frame_hash_data_path(path)
            if not self.force and fhp.exists():
                try:
                    data = FrameHashes.from_path(fhp)
                except Exception:
                    data = None
                if data is not None and data.md5() == md5:
                    print(f"Skipping analysis for {path}...")
                    return ("cached", data)
            if self._use_device_ingest(path):
                segs = self._raw_segments(path)
                return (md5, segs[6], segs[2] is not None, "raw", segs[:6])
            opening_pcm, ending_pcm, _, seek_to = self._decode_segments(path)
            monos = (
                downmix_stereo_i16(opening_pcm),
                None if ending_pcm is None else downmix_stereo_i16(ending_pcm),
            )
            return (md5, seek_to, ending_pcm is not None, "decoded", monos)

        dispatchers: dict = {}  # (rate, channels) -> IngestDispatcher
        mono_segments: List[np.ndarray] = []
        mono_refs: List[tuple] = []  # (video index, "opening" / "ending")
        prepped: List[tuple] = []

        def consume(vi: int, item: tuple) -> None:
            # each episode's raw windows join the device lane chunks as soon
            # as it is read, so reads overlap the dispatches
            prepped.append(item)
            if item[0] == "cached":
                return
            if item[3] == "decoded":
                for side, mono in zip(("opening", "ending"), item[4]):
                    if mono is not None:
                        mono_segments.append(mono)
                        mono_refs.append((vi, side))
                return
            op_seg, op_nv, en_seg, en_nv, rate, channels = item[4]
            d = dispatchers.get((rate, channels))
            if d is None:
                d = dispatchers[(rate, channels)] = IngestDispatcher(
                    rate, channels, self.device
                )
            d.add((vi, "opening"), op_seg, op_nv)
            if en_seg is not None:
                d.add((vi, "ending"), en_seg, en_nv)

        with span("analyze.decode", videos=len(videos)):
            if threading and len(videos) > 1:
                import os

                workers = max(1, min(4, os.cpu_count() or 4))
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for vi, item in enumerate(pool.map(prepare, videos)):
                        consume(vi, item)
            else:
                for vi, path in enumerate(videos):
                    consume(vi, prepare(path))

        hashes_by_ref = {}
        with span(
            "analyze.fingerprint", mono=len(mono_segments),
            raw=sum(len(d._out_lens) for d in dispatchers.values()),
        ):
            if mono_segments:
                outs = fingerprint_batch(mono_segments, self.device)
                hashes_by_ref.update(zip(mono_refs, outs))
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
