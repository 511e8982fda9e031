"""Persistent data formats: `.needle.dat` frame hashes and `.needle.skip.json`.

Bit-compatible with the reference's on-disk formats:

  * `.needle.dat` — bincode-v1 encoding of
    ``FrameHashes { version: FrameHashesVersion, data: FrameHashesData::V1(FrameHashesV1) }``
    where ``FrameHashesV1 = { opening: Vec<(u32, Duration)>, ending: Vec<(u32, Duration)>,
    hash_duration: Duration, md5: String }`` (needle/src/audio/data.rs:15-80).
    bincode (v1, default options) encodes enums as a little-endian u32 *variant
    index* (both `version` and `data` are index 0 on disk), Vec/String with a
    u64 LE length prefix, and `std::time::Duration` as (u64 secs, u32 nanos).

  * `.needle.skip.json` — serde_json of
    ``SkipFile { opening: Option<(f32, f32)>, ending: Option<(f32, f32)>, md5: String }``
    (data.rs:8-13), written compactly with ryu shortest-round-trip f32 floats
    (e.g. ``{"opening":null,"ending":[1331.6644,1419.0249],"md5":"..."}``).

The port's own copy of needle_tpu/data.py: each package reads the other's
files, byte for byte (tests/test_torch_copies.py).
"""

from __future__ import annotations

import io
import json
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .constants import FRAME_HASH_DATA_FILE_NAME, SKIP_FILE_NAME
from .duration import Duration
from .errors import (
    Error,
    FrameHashDataInvalidVersion,
    FrameHashDataNotFound,
)

# bincode enum variant indices (little-endian u32 on disk). Note the Rust
# discriminant `FrameHashesVersion::V1 = 12345` (data.rs:17) is NOT what is
# serialized -- bincode writes the variant *index*, which is 0.
_VERSION_V1_INDEX = 0
_DATA_V1_INDEX = 0


def with_rust_extension(path, extension: str) -> Path:
    """Rust `Path::with_extension` semantics: replace the *final* extension.

    ``ep1.mp4`` -> ``ep1.needle.dat``; ``ep1`` -> ``ep1.needle.dat``;
    ``ep1.foo.mkv`` -> ``ep1.foo.needle.dat``.
    (used at analyzer.rs:336, comparator.rs:310-314, data.rs:125-127)
    """
    path = Path(path)
    stem, _ = os.path.splitext(path.name)
    return path.with_name(f"{stem}.{extension}")


def shortest_f32_repr(value) -> str:
    """Shortest decimal string that round-trips to the given f32.

    Mirrors serde_json's ryu output for f32 (e.g. 1331.664387072 -> "1331.6644").
    """
    v = np.float32(value)
    if np.isnan(v) or np.isinf(v):
        raise ValueError("cannot serialize non-finite f32 to JSON")
    # ryu prints positional notation for the whole magnitude range that
    # timestamps occupy; %g-style formatting would switch to scientific
    # notation for round values (90.0 -> "9e+01") and break byte-compat.
    s = np.format_float_positional(v, unique=True, trim="0")
    if "." not in s:
        s += ".0"
    return s


# ---------------------------------------------------------------------------
# bincode primitives (v1 default options: little-endian, fixed-int)
# ---------------------------------------------------------------------------


def _read_exactly(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise Error("unexpected EOF while reading bincode data")
    return b


def _write_duration(out: io.BytesIO, d: Duration) -> None:
    out.write(struct.pack("<QI", d.secs, d.subsec_nanos))


def _read_duration(f) -> Duration:
    secs, nanos = struct.unpack("<QI", _read_exactly(f, 12))
    return Duration(secs, nanos)


def _write_hash_vec(out: io.BytesIO, hashes: np.ndarray, ts_nanos: np.ndarray) -> None:
    n = len(hashes)
    out.write(struct.pack("<Q", n))
    # Each element is a tuple (u32, Duration) = (u32, u64 secs, u32 nanos).
    secs = ts_nanos // 1_000_000_000
    nanos = ts_nanos % 1_000_000_000
    rec = np.zeros(n, dtype=[("h", "<u4"), ("s", "<u8"), ("n", "<u4")])
    rec["h"] = hashes
    rec["s"] = secs
    rec["n"] = nanos
    out.write(rec.tobytes())


def _read_hash_vec(f) -> Tuple[np.ndarray, np.ndarray]:
    (n,) = struct.unpack("<Q", _read_exactly(f, 8))
    if n > (1 << 40):
        raise Error("corrupt bincode data: unreasonable vector length")
    raw = _read_exactly(f, n * 16)
    rec = np.frombuffer(raw, dtype=[("h", "<u4"), ("s", "<u8"), ("n", "<u4")])
    hashes = rec["h"].astype(np.uint32)
    ts_nanos = rec["s"].astype(np.int64) * 1_000_000_000 + rec["n"].astype(np.int64)
    return hashes, ts_nanos


@dataclass
class SkipFile:
    """Mirror of the reference `SkipFile` struct (data.rs:8-13)."""

    opening: Optional[Tuple[float, float]]
    ending: Optional[Tuple[float, float]]
    md5: str

    def to_json_bytes(self) -> bytes:
        def fmt(pair):
            if pair is None:
                return "null"
            a, b = pair
            return f"[{shortest_f32_repr(a)},{shortest_f32_repr(b)}]"

        s = (
            "{"
            f'"opening":{fmt(self.opening)},'
            f'"ending":{fmt(self.ending)},'
            f'"md5":{json.dumps(self.md5)}'
            "}"
        )
        return s.encode("utf-8")

    @classmethod
    def from_json_bytes(cls, data: bytes) -> "SkipFile":
        obj = json.loads(data)
        op = tuple(obj["opening"]) if obj.get("opening") is not None else None
        en = tuple(obj["ending"]) if obj.get("ending") is not None else None
        return cls(opening=op, ending=en, md5=obj["md5"])

    def write(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.to_json_bytes())

    @classmethod
    def read(cls, path) -> "SkipFile":
        with open(path, "rb") as f:
            return cls.from_json_bytes(f.read())


class FrameHashes:
    """Frame hash data for a single video (reference data.rs:74-169).

    Hashes and timestamps are held as NumPy arrays (uint32 hash values and
    int64 timestamp nanoseconds) so the TPU engines can consume them directly;
    the (de)serializers preserve the reference's exact bincode layout.
    """

    __slots__ = (
        "opening_hashes",
        "opening_ts_nanos",
        "ending_hashes",
        "ending_ts_nanos",
        "_hash_duration",
        "_md5",
    )

    def __init__(
        self,
        opening_hashes: np.ndarray,
        opening_ts_nanos: np.ndarray,
        ending_hashes: np.ndarray,
        ending_ts_nanos: np.ndarray,
        hash_duration: Duration,
        md5: str,
    ):
        self.opening_hashes = np.asarray(opening_hashes, dtype=np.uint32)
        self.opening_ts_nanos = np.asarray(opening_ts_nanos, dtype=np.int64)
        self.ending_hashes = np.asarray(ending_hashes, dtype=np.uint32)
        self.ending_ts_nanos = np.asarray(ending_ts_nanos, dtype=np.int64)
        self._hash_duration = hash_duration
        self._md5 = md5

    # -- constructors mirroring the reference --------------------------------

    @classmethod
    def new_v1(cls, opening, ending, hash_duration: Duration, md5: str) -> "FrameHashes":
        """Build from lists of (hash, Duration) pairs (data.rs:83-93)."""

        def split(pairs):
            if len(pairs) == 0:
                return np.zeros(0, np.uint32), np.zeros(0, np.int64)
            hs = np.array([p[0] for p in pairs], dtype=np.uint32)
            ts = np.array([p[1].total_nanos() for p in pairs], dtype=np.int64)
            return hs, ts

        oh, ot = split(opening)
        eh, et = split(ending)
        return cls(oh, ot, eh, et, hash_duration, md5)

    # -- accessors mirroring the reference ------------------------------------

    def opening_data(self):
        """List of (hash, Duration) pairs (data.rs:143-147)."""
        return list(
            zip(
                (int(h) for h in self.opening_hashes),
                (Duration.from_nanos(int(t)) for t in self.opening_ts_nanos),
            )
        )

    def ending_data(self):
        return list(
            zip(
                (int(h) for h in self.ending_hashes),
                (Duration.from_nanos(int(t)) for t in self.ending_ts_nanos),
            )
        )

    def hash_duration(self) -> Duration:
        return self._hash_duration

    def md5(self) -> str:
        return self._md5

    # -- bincode (de)serialization --------------------------------------------

    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        out.write(struct.pack("<I", _VERSION_V1_INDEX))
        out.write(struct.pack("<I", _DATA_V1_INDEX))
        _write_hash_vec(out, self.opening_hashes, self.opening_ts_nanos)
        _write_hash_vec(out, self.ending_hashes, self.ending_ts_nanos)
        _write_duration(out, self._hash_duration)
        md5_bytes = self._md5.encode("utf-8")
        out.write(struct.pack("<Q", len(md5_bytes)))
        out.write(md5_bytes)
        return out.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "FrameHashes":
        """Decode a `.needle.dat` payload. Any corruption — truncation,
        garbage lengths, invalid UTF-8, bad variant indices — surfaces as a
        needle `Error` subclass, never a raw struct/codec exception
        (reference data.rs:104-115: bincode failures wrap into
        needle::Error)."""
        try:
            f = io.BytesIO(data)
            (version_idx,) = struct.unpack("<I", _read_exactly(f, 4))
            if version_idx != _VERSION_V1_INDEX:
                # bincode would fail to decode an unknown variant index; the
                # reference maps that to a bincode error / invalid version.
                raise FrameHashDataInvalidVersion()
            (data_idx,) = struct.unpack("<I", _read_exactly(f, 4))
            if data_idx != _DATA_V1_INDEX:
                raise FrameHashDataInvalidVersion()
            oh, ot = _read_hash_vec(f)
            eh, et = _read_hash_vec(f)
            hash_duration = _read_duration(f)
            (md5_len,) = struct.unpack("<Q", _read_exactly(f, 8))
            if md5_len > (1 << 20):
                raise Error("corrupt bincode data: unreasonable string length")
            md5 = _read_exactly(f, md5_len).decode("utf-8")
            return cls(oh, ot, eh, et, hash_duration, md5)
        except Error:
            raise
        except (struct.error, UnicodeDecodeError, ValueError, OverflowError,
                MemoryError) as e:
            raise Error(f"corrupt bincode data: {e}") from e

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    @classmethod
    def from_path(cls, path) -> "FrameHashes":
        """Load frame hashes from a `.needle.dat` path (data.rs:104-115)."""
        path = Path(path)
        if not path.exists():
            raise FrameHashDataNotFound(path)
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_video(cls, video, analyze: bool = False, **analyzer_kwargs) -> "FrameHashes":
        """Load frame hash data using a video path (data.rs:121-140).

        If `analyze` is set, the video is analyzed in-place by this
        package's Analyzer (force=True, not persisted, default hash
        duration; `analyzer_kwargs` may name its device); otherwise the
        `.needle.dat` file alongside the video is loaded.
        """
        if not analyze:
            return cls.from_path(with_rust_extension(video, FRAME_HASH_DATA_FILE_NAME))
        from .analyzer import Analyzer
        from .constants import DEFAULT_HASH_DURATION

        analyzer = Analyzer([], **analyzer_kwargs).with_force(True)
        hash_duration = Duration.from_secs_f32(DEFAULT_HASH_DURATION)
        return analyzer.run_single(video, hash_duration, persist=False)

    def __repr__(self) -> str:
        return (
            f"FrameHashes(opening={len(self.opening_hashes)} hashes, "
            f"ending={len(self.ending_hashes)} hashes, "
            f"hash_duration={self._hash_duration!r}, md5={self._md5!r})"
        )


def skip_file_path(video) -> Path:
    return with_rust_extension(video, SKIP_FILE_NAME)


def frame_hash_data_path(video) -> Path:
    return with_rust_extension(video, FRAME_HASH_DATA_FILE_NAME)
