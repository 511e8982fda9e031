"""A season format for the tests, dropped into a catalog's formats/: FLAC in
Matroska beside a 16x16 mjpeg video track (the reference's validity check
wants a video stream, util.rs:40-52), written and decoded through FFmpeg by
the repository's native ingest library (native/libneedle_ingest.so), bound
here by ctypes.

The analyzer reads such a file by the decoded route: the container's
stream duration, the opening window decoded from the start for the
opening_window share of it, the ending window decoded after a seek to the
ms-truncated stream x (1 - ending_window), each resampled to 11025 Hz
stereo (analyzer.py `_decode_segments_av`)."""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

import needle_bench
from needle_bench.reference.files import NS, from_secs_f64, mul_f32

EXT = "mkv"
SPEC_KEYS = ("codec", "channels")
LIB = Path(needle_bench.__file__).resolve().parents[1] / "native" / "libneedle_ingest.so"
OUT_RATE = 11025  # the decoded route's rate, stereo


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    c = ctypes
    lib = c.CDLL(str(LIB))
    lib.ni_write_media.argtypes = [c.c_char_p, c.c_char_p, c.c_void_p, c.c_int64,
                                   c.c_int, c.c_int, c.c_int, c.c_char_p, c.c_int]
    lib.ni_write_media.restype = c.c_int
    lib.ni_decode_audio.argtypes = [c.c_char_p, c.c_double, c.c_double, c.c_int, c.c_int,
                                    c.POINTER(c.POINTER(c.c_int16)), c.POINTER(c.c_int64),
                                    c.POINTER(c.c_double), c.c_char_p, c.c_int]
    lib.ni_decode_audio.restype = c.c_int
    lib.ni_free.argtypes = [c.c_void_p]
    lib.ni_free.restype = None
    return lib


def write(path, pcm: np.ndarray, spec: dict) -> None:
    frames = np.ascontiguousarray(
        np.repeat(pcm.astype("<i2")[:, None], spec["channels"], axis=1))
    err = ctypes.create_string_buffer(512)
    rc = _lib().ni_write_media(os.fsencode(str(path)), spec["codec"].encode(),
                               frames.ctypes.data, len(pcm), spec["rate"],
                               spec["channels"], 1, err, len(err))
    if rc != 0:
        raise OSError(f"ni_write_media {path}: {err.value.decode(errors='replace')}")


def _decode(path, seek_s: float, limit_s: float):
    """(interleaved i16 stereo at OUT_RATE, stream duration s); a negative
    seek or limit means none."""
    lib = _lib()
    buf = ctypes.POINTER(ctypes.c_int16)()
    n, dur = ctypes.c_int64(), ctypes.c_double()
    err = ctypes.create_string_buffer(512)
    rc = lib.ni_decode_audio(os.fsencode(str(path)), seek_s, limit_s, OUT_RATE, 0,
                             ctypes.byref(buf), ctypes.byref(n), ctypes.byref(dur),
                             err, len(err))
    if rc != 0:
        raise OSError(f"ni_decode_audio {path}: {err.value.decode(errors='replace')}")
    try:
        samples = (np.ctypeslib.as_array(buf, shape=(n.value,)).copy() if n.value
                   else np.zeros(0, np.int16))
    finally:
        lib.ni_free(buf)
    return samples, dur.value


def windows(path, cfg: dict):
    stream_ns = from_secs_f64(_decode(path, -1.0, 0.0)[1])
    opening_ns = mul_f32(stream_ns, cfg["opening_window"])
    opening, _ = _decode(path, -1.0, float(opening_ns // NS) + float(opening_ns % NS) / 1e9)
    seek_ns = mul_f32(stream_ns, np.float32(1.0) - np.float32(cfg["ending_window"]))
    ending, _ = _decode(path, (seek_ns // 1_000_000) / 1000.0, -1.0)
    return (stream_ns, (opening, opening.size, OUT_RATE, 2),
            (ending, ending.size, OUT_RATE, 2), seek_ns)
