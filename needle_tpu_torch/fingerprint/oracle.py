"""ctypes binding to a system libchromaprint: the `chromaprint` analyze
backend.

The port's own copy of needle_tpu/fingerprint/oracle.py. The port's own
fingerprint paths are the torch ingest and the NumPy pipeline; this module
provides the optional "exact" backend for users who require `.needle.dat`
files bit-identical to the library the reference links against
(chromaprint 1.5.x). There is no fallback: a missing library raises.
Of needle_tpu's binding it keeps what the backend calls; the golden-test
accessors (delay, item duration, sample rate, simhash) stay needle_tpu's.

Mirrors the usage in needle/src/audio/analyzer.rs:176-311 (start -> feed ->
finish -> get_fingerprint_raw).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

# Default algorithm: CHROMAPRINT_ALGORITHM_TEST2 == 1 (chromaprint.h).
ALGORITHM_TEST2 = 1

_LIB_CANDIDATES = (
    "libchromaprint.so.1",
    "libchromaprint.so",
    "libchromaprint.1.dylib",
    "libchromaprint.dylib",
)

_lib = None
_lib_checked = False
_lib_lock = threading.Lock()


def load_library() -> Optional[ctypes.CDLL]:
    """Load libchromaprint if available, configuring prototypes. Returns None
    if the library is not installed."""
    with _lib_lock:
        return _load_library_locked()


def _load_library_locked() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    path = ctypes.util.find_library("chromaprint")
    names = ([path] if path else []) + list(_LIB_CANDIDATES)
    lib = None
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if lib is None:
        return None

    c = ctypes
    lib.chromaprint_new.restype = c.c_void_p
    lib.chromaprint_new.argtypes = [c.c_int]
    lib.chromaprint_free.restype = None
    lib.chromaprint_free.argtypes = [c.c_void_p]
    lib.chromaprint_start.restype = c.c_int
    lib.chromaprint_start.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.chromaprint_feed.restype = c.c_int
    lib.chromaprint_feed.argtypes = [c.c_void_p, c.POINTER(c.c_int16), c.c_int]
    lib.chromaprint_finish.restype = c.c_int
    lib.chromaprint_finish.argtypes = [c.c_void_p]
    lib.chromaprint_get_raw_fingerprint.restype = c.c_int
    lib.chromaprint_get_raw_fingerprint.argtypes = [
        c.c_void_p,
        c.POINTER(c.POINTER(c.c_uint32)),
        c.POINTER(c.c_int),
    ]
    lib.chromaprint_dealloc.restype = None
    lib.chromaprint_dealloc.argtypes = [c.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


class ChromaprintOracle:
    """Minimal equivalent of chromaprint_rust::Context."""

    def __init__(self, algorithm: int = ALGORITHM_TEST2):
        lib = load_library()
        if lib is None:
            raise RuntimeError("libchromaprint not available")
        self._lib = lib
        self._ctx = lib.chromaprint_new(algorithm)
        if not self._ctx:
            raise RuntimeError("chromaprint_new failed")

    def close(self):
        if self._ctx:
            self._lib.chromaprint_free(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def start(self, sample_rate: int, channels: int) -> None:
        if self._lib.chromaprint_start(self._ctx, sample_rate, channels) != 1:
            raise RuntimeError("chromaprint_start failed")

    def feed(self, samples: np.ndarray) -> None:
        """Feed interleaved i16 samples (like analyzer.rs:275)."""
        samples = np.ascontiguousarray(samples, dtype=np.int16)
        ptr = samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        if self._lib.chromaprint_feed(self._ctx, ptr, samples.size) != 1:
            raise RuntimeError("chromaprint_feed failed")

    def finish(self) -> None:
        if self._lib.chromaprint_finish(self._ctx) != 1:
            raise RuntimeError("chromaprint_finish failed")

    def get_raw_fingerprint(self) -> np.ndarray:
        fp_ptr = ctypes.POINTER(ctypes.c_uint32)()
        size = ctypes.c_int()
        if (
            self._lib.chromaprint_get_raw_fingerprint(
                self._ctx, ctypes.byref(fp_ptr), ctypes.byref(size)
            )
            != 1
        ):
            raise RuntimeError("chromaprint_get_raw_fingerprint failed")
        try:
            out = np.ctypeslib.as_array(fp_ptr, shape=(size.value,)).astype(np.uint32)
        finally:
            self._lib.chromaprint_dealloc(fp_ptr)
        return out


def fingerprint_oracle(mono_or_stereo_i16: np.ndarray, channels: int = 1) -> np.ndarray:
    """One-shot raw fingerprint of i16 PCM at 11025 Hz via libchromaprint."""
    ctx = ChromaprintOracle()
    ctx.start(11025, channels)
    ctx.feed(mono_or_stereo_i16)
    ctx.finish()
    fp = ctx.get_raw_fingerprint()
    ctx.close()
    return fp
