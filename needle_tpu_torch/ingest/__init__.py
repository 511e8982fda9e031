"""Host-side media ingest: the port's ctypes binding of the native FFmpeg
layer, and the WAV / raw-PCM readers.

The reference does all media IO through FFmpeg's C libraries via ffmpeg-next
(needle/src/audio/analyzer.rs, util.rs). The equivalent native layer is the
repository's shared C++ library `native/needle_ingest.cpp`
(libavformat/libavcodec/libswresample, built as
`native/libneedle_ingest.so`), exposed over a C ABI. This module is the
port's copy of what it uses of needle_tpu/ingest: probe, decode and the
stream duration for compressed media, and the host resampler
(`resample_pcm_to_stereo`, `load_pcm_as_chromaprint_input`) of the
`numpy` and `chromaprint` analyze backends. It reproduces the reference's
decode semantics exactly (packet pts filtering, resample chain, seek
behavior) so fingerprints and timestamps agree.

The library is loaded lazily, on the first probe, decode or resample: the
raw-PCM readers (`read_wav`, `read_pcm_mmap`, `is_pcm_file`) need no
FFmpeg.
NEEDLE_TPU_INGEST_LIB points at another ABI-compatible build.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_NAME = "libneedle_ingest.so"

_lib = None
_lib_lock = __import__("threading").Lock()


class IngestError(RuntimeError):
    pass


_build_failed = False


def _build_native() -> Optional[Path]:
    global _build_failed
    # Explicit override (sanitizer builds, cross-build testing): point
    # NEEDLE_TPU_INGEST_LIB at any ABI-compatible build of the library.
    override = os.environ.get("NEEDLE_TPU_INGEST_LIB")
    if override:
        p = Path(override)
        if not p.exists():
            raise IngestError(f"NEEDLE_TPU_INGEST_LIB does not exist: {p}")
        return p
    # installed-package layout: a prebuilt .so shipped inside
    # needle_tpu_torch/_native/; source checkouts build under native/.
    packaged = Path(__file__).resolve().parent.parent / "_native" / _LIB_NAME
    if packaged.exists():
        return packaged
    so = _NATIVE_DIR / _LIB_NAME
    if so.exists():
        return so
    if _build_failed:
        return None  # don't re-run a failing 300 s build per call
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True,
            capture_output=True,
            timeout=300,
        )
    except Exception:
        _build_failed = True
        return None
    if so.exists():
        return so
    _build_failed = True
    return None


def load_native() -> ctypes.CDLL:
    with _lib_lock:
        return _load_native_locked()


def _load_native_locked() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so = _build_native()
    if so is None:
        raise IngestError(
            "native ingest library unavailable (build native/libneedle_ingest.so)"
        )
    lib = ctypes.CDLL(str(so))
    c = ctypes
    lib.ni_avutil_version.restype = c.c_uint
    lib.ni_free.argtypes = [c.c_void_p]
    lib.ni_free.restype = None
    lib.ni_probe.argtypes = [
        c.c_char_p,
        c.POINTER(c.c_int),
        c.POINTER(c.c_int),
        c.c_char_p,
        c.c_int,
    ]
    lib.ni_probe.restype = c.c_int
    lib.ni_decode_audio.argtypes = [
        c.c_char_p,
        c.c_double,
        c.c_double,
        c.c_int,
        c.c_int,
        c.POINTER(c.POINTER(c.c_int16)),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_double),
        c.c_char_p,
        c.c_int,
    ]
    lib.ni_decode_audio.restype = c.c_int
    lib.ni_resample_pcm.argtypes = [
        c.c_void_p,
        c.c_int64,
        c.c_int,
        c.c_int,
        c.c_int,
        c.c_int,
        c.POINTER(c.POINTER(c.c_int16)),
        c.POINTER(c.c_int64),
        c.c_char_p,
        c.c_int,
    ]
    lib.ni_resample_pcm.restype = c.c_int
    _lib = lib
    return _lib


def _adopt_native_i16(buf, n: int) -> np.ndarray:
    """Wrap a native-malloc'd i16 output buffer as an ndarray WITHOUT
    copying; ni_free runs when the array (and every view of it) is
    garbage-collected.

    OWNERSHIP CONTRACT: the returned array OWNS the native buffer through
    numpy's base-chaining — slices, reshapes, and any view keep the
    wrapper (and therefore the finalizer) alive, so ordinary ndarray use
    is safe. What is NOT safe is extracting the raw address and letting
    every array object die: `arr.ctypes.data`,
    `arr.__array_interface__["data"]`, or a ctypes pointer cast dangles
    once the last referencing ndarray is collected. Consumers that need
    the buffer beyond ndarray lifetime must .copy()."""
    import weakref

    lib = load_native()
    if n <= 0:
        lib.ni_free(buf)
        return np.zeros(0, np.int16)
    try:
        arr = np.ctypeslib.as_array(buf, shape=(n,))
        weakref.finalize(arr, lib.ni_free, ctypes.cast(buf, ctypes.c_void_p))
    except BaseException:
        # adoption failed between native return and finalizer registration
        # (e.g. MemoryError): free here or the PCM buffer leaks
        lib.ni_free(buf)
        raise
    return arr


@dataclass
class ProbeInfo:
    num_video_streams: int
    num_audio_streams: int


def probe(path) -> ProbeInfo:
    """Count video/audio streams (reference util.rs:40-52)."""
    lib = load_native()
    nv, na = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    rc = lib.ni_probe(
        os.fsencode(str(path)), ctypes.byref(nv), ctypes.byref(na), err, len(err)
    )
    if rc != 0:
        raise IngestError(err.value.decode(errors="replace"))
    return ProbeInfo(nv.value, na.value)


def native_ffmpeg_version() -> int:
    return load_native().ni_avutil_version()


class SeekPastEnd(IngestError):
    """Mirror of the reference's seek assertion (audio/util.rs:29-32)."""


def decode_audio(
    path,
    seek_to_secs: Optional[float] = None,
    duration_limit_secs: Optional[float] = None,
    sample_rate: int = 11025,
    threaded: bool = False,
) -> Tuple[np.ndarray, float]:
    """Decode the best audio stream to S16 interleaved stereo PCM.

    Returns (interleaved int16 array, stream_duration_secs), mirroring the
    reference's process_frames decode path (analyzer.rs:156-284). The
    array adopts a native buffer zero-copy — see `_adopt_native_i16`'s
    ownership contract (keep the ndarray alive; don't detach raw
    pointers).
    """
    lib = load_native()
    buf = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64()
    dur = ctypes.c_double()
    err = ctypes.create_string_buffer(512)
    rc = lib.ni_decode_audio(
        os.fsencode(str(path)),
        -1.0 if seek_to_secs is None else float(seek_to_secs),
        -1.0 if duration_limit_secs is None else float(duration_limit_secs),
        sample_rate,
        1 if threaded else 0,
        ctypes.byref(buf),
        ctypes.byref(n),
        ctypes.byref(dur),
        err,
        len(err),
    )
    if rc == -2:
        raise SeekPastEnd(err.value.decode(errors="replace"))
    if rc != 0:
        raise IngestError(err.value.decode(errors="replace"))
    samples = _adopt_native_i16(buf, n.value)
    return samples, dur.value


def stream_duration_secs(path) -> float:
    """The reference's stream-duration value without decoding (used to plan
    opening/ending windows). Cheap: opens the container only."""
    # decode 0 seconds: end timestamp == seek0 -> loop exits immediately.
    _, dur = decode_audio(path, None, 0.0)
    return dur


def resample_pcm_to_stereo(
    pcm: np.ndarray, in_rate: int, channels: int, out_rate: int = 11025
) -> np.ndarray:
    """Resample arbitrary PCM (int16 or float32, interleaved) to S16
    interleaved stereo via swresample — the same resampler family the
    reference's decode chain uses. Returns a zero-copy adoption of a
    native buffer (`_adopt_native_i16` ownership contract applies)."""
    pcm = np.ascontiguousarray(pcm)
    if pcm.dtype == np.int16:
        fmt = 0
    elif pcm.dtype == np.float32:
        fmt = 1
    else:
        raise ValueError(f"unsupported PCM dtype {pcm.dtype}")
    if pcm.ndim == 2:
        channels = pcm.shape[1]
        pcm = pcm.reshape(-1)
    n_frames = pcm.size // channels
    lib = load_native()
    buf = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(512)
    rc = lib.ni_resample_pcm(
        pcm.ctypes.data_as(ctypes.c_void_p),
        n_frames,
        in_rate,
        channels,
        fmt,
        out_rate,
        ctypes.byref(buf),
        ctypes.byref(n),
        err,
        len(err),
    )
    if rc != 0:
        raise IngestError(err.value.decode(errors="replace"))
    return _adopt_native_i16(buf, n.value)


# ---------------------------------------------------------------------------
# Pre-decoded PCM file ingestion (WAV / raw), for pipelines that feed audio
# directly (e.g. benchmark configs supplying 16 kHz mono PCM).
# ---------------------------------------------------------------------------


def read_wav(path) -> Tuple[np.ndarray, int, int]:
    """Minimal RIFF/WAVE reader for PCM16/float32. Returns (interleaved,
    sample_rate, channels).

    The sample payload is read with a single np.fromfile at the data
    chunk's offset — no intermediate Python bytes copy."""
    import os as _os
    import struct as _struct

    file_size = _os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(65536)
    if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise IngestError(f"not a WAV file: {path}")
    pos = 12
    fmt = None
    data_off, data_size = None, None
    while pos + 8 <= file_size:
        if pos + 8 > len(head):
            with open(path, "rb") as f:
                f.seek(pos)
                hdr = f.read(8)
        else:
            hdr = head[pos : pos + 8]
        if len(hdr) < 8:
            break
        cid = hdr[:4]
        (size,) = _struct.unpack("<I", hdr[4:8])
        if cid == b"fmt ":
            body = head[pos + 8 : pos + 24]
            if len(body) < 16:
                with open(path, "rb") as f:
                    f.seek(pos + 8)
                    body = f.read(16)
            fmt = _struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data_off, data_size = pos + 8, min(size, file_size - pos - 8)
        pos += 8 + size + (size & 1)
    if fmt is None or data_off is None:
        raise IngestError(f"malformed WAV file: {path}")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt == 1 and bits == 16:
        dtype = np.dtype("<i2")
    elif audio_fmt == 3 and bits == 32:
        dtype = np.dtype("<f4")
    else:
        raise IngestError(f"unsupported WAV format {audio_fmt}/{bits}bit: {path}")
    samples = np.fromfile(path, dtype=dtype, count=data_size // dtype.itemsize,
                          offset=data_off)
    return samples, rate, channels


def is_pcm_file(path) -> bool:
    p = str(path).lower()
    return p.endswith(".wav") or p.endswith(".pcm") or p.endswith(".raw")


def read_pcm_raw(
    path, raw_rate: int = 16000, raw_channels: int = 1, raw_dtype=np.int16
) -> Tuple[np.ndarray, int, int, float]:
    """Read a WAV or raw-PCM file WITHOUT resampling. Returns
    (interleaved i16 samples, rate, channels, duration_secs).

    Used by the device-ingest path: source-rate samples are uploaded and
    resampled/downmixed on the device instead of via host swr.
    """
    p = str(path).lower()
    if p.endswith(".wav"):
        samples, rate, channels = read_wav(path)
    else:
        samples = np.fromfile(path, dtype=raw_dtype)
        rate, channels = raw_rate, raw_channels
    if samples.dtype != np.int16:
        # float PCM -> i16 with rounding (matching swresample's conversion)
        samples = np.clip(
            np.rint(samples.astype(np.float64) * 32768.0), -32768, 32767
        ).astype(np.int16)
    duration = (samples.size // channels) / rate
    return samples, rate, channels, duration


def read_pcm_mmap(
    path, raw_rate: int = 16000, raw_channels: int = 1
) -> Tuple[np.ndarray, int, int, float]:
    """Like read_pcm_raw but zero-copy: i16 WAV/raw payloads are returned as
    a read-only np.memmap view, so slicing the opening/ending windows costs
    nothing and bytes are only faulted in when the upload path copies them.
    Non-i16 payloads fall back to read_pcm_raw (full read + convert)."""
    import struct as _struct

    p = str(path).lower()
    if p.endswith(".wav"):
        file_size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(65536)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise IngestError(f"not a WAV file: {path}")
        pos, fmt, data_off, data_size = 12, None, None, None
        while pos + 8 <= file_size:
            hdr = head[pos : pos + 8]
            if len(hdr) < 8:
                with open(path, "rb") as f:
                    f.seek(pos)
                    hdr = f.read(8)
                if len(hdr) < 8:
                    break
            cid = hdr[:4]
            (size,) = _struct.unpack("<I", hdr[4:8])
            if cid == b"fmt ":
                body = head[pos + 8 : pos + 24]
                if len(body) < 16:
                    with open(path, "rb") as f:
                        f.seek(pos + 8)
                        body = f.read(16)
                fmt = _struct.unpack("<HHIIHH", body[:16])
            elif cid == b"data":
                data_off, data_size = pos + 8, min(size, file_size - pos - 8)
            pos += 8 + size + (size & 1)
        if fmt is None or data_off is None:
            raise IngestError(f"malformed WAV file: {path}")
        audio_fmt, channels, rate, _, _, bits = fmt
        if not (audio_fmt == 1 and bits == 16):
            samples, rate, channels, dur = read_pcm_raw(path)
            return samples, rate, channels, dur
        n = data_size // 2
        samples = np.memmap(path, dtype="<i2", mode="r", offset=data_off,
                            shape=(n,))
    else:
        n = os.path.getsize(path) // 2
        samples = np.memmap(path, dtype="<i2", mode="r", shape=(n,))
        rate, channels = raw_rate, raw_channels
    duration = (samples.size // channels) / rate
    return samples, rate, channels, duration


def load_pcm_as_chromaprint_input(
    path, raw_rate: int = 16000, raw_channels: int = 1, raw_dtype=np.int16
) -> Tuple[np.ndarray, float]:
    """Read a WAV or raw-PCM file and convert to S16 interleaved stereo at
    11025 Hz (chromaprint's native input in the reference chain). Returns
    (interleaved stereo i16, duration_secs of the source). The host route
    of the `numpy` and `chromaprint` analyze backends."""
    p = str(path).lower()
    if p.endswith(".wav"):
        samples, rate, channels = read_wav(path)
    else:
        samples = np.fromfile(path, dtype=raw_dtype)
        rate, channels = raw_rate, raw_channels
    duration = (samples.size // channels) / rate
    out = resample_pcm_to_stereo(samples, rate, channels)
    return out, duration
