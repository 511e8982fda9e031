"""What the analyzer should write for one episode, and plain readers of the
files the port writes.

The analyzer (needle/src/audio/analyzer.rs:286-420, as the port copies it)
hashes two windows of each episode: the opening window, the first
opening_window share of the stream, and the ending window, from
stream x (1 - ending_window) (truncated to whole milliseconds) to the end.
How each window is read (whole at the source rate, or decoded) is the
season format's (formats/; `raw_windows` is the raw route's rule). It
keeps every step-th hash (step = hash duration in ms // the 123 ms item),
stamps hash i with delay + item x i (Rust Duration arithmetic in float32),
adds the seek to the ending's, and stores them with the MD5 of the file's
first 8 KiB as bincode:

  u32 0, u32 0 (version and data variants), then for the opening and the
  ending a u64 count and (u32 hash, u64 s, u32 ns) records, then the hash
  duration (u64 s, u32 ns) and the MD5 as a u64 length and its bytes.

A skip file is JSON: {"opening": [start, end] or null, "ending": ...,
"md5": ...}, the times float32 seconds. Imports nothing of the port.
"""

from __future__ import annotations

import hashlib
import json
import struct
from fractions import Fraction

import numpy as np

from .fingerprint import DELAY_SAMPLES, HOP_SIZE, SAMPLE_RATE, lane_hashes

NS = 1_000_000_000
_REC = np.dtype([("h", "<u4"), ("s", "<u8"), ("n", "<u4")])


# -- Rust Duration arithmetic, on integer nanoseconds --------------------

def from_secs_f64(x: float) -> int:
    return round(Fraction(float(x)) * NS)


def from_secs_f32(x) -> int:
    return round(Fraction(float(np.float32(x))) * NS)


def as_secs_f32(ns: int) -> np.float32:
    return np.float32(ns // NS) + np.float32(ns % NS) / np.float32(NS)


def mul_f32(ns: int, r) -> int:
    return from_secs_f32(np.float32(r) * as_secs_f32(ns))


ITEM_NS = from_secs_f64(HOP_SIZE / SAMPLE_RATE)
DELAY_NS = from_secs_f64(DELAY_SAMPLES / SAMPLE_RATE)


def header_md5(path) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read(8192)).hexdigest()


def _stamps(count: int, step: int, offset_ns: int) -> np.ndarray:
    idx = np.arange(0, count * step, step, dtype=np.int64)
    prods = np.float32(idx.astype(np.float32) * as_secs_f32(ITEM_NS))
    return np.array([round(Fraction(float(p)) * NS) for p in prods],
                    dtype=np.int64) + DELAY_NS + offset_ns


def raw_windows(samples: np.ndarray, rate: int, channels: int, cfg: dict):
    """A season format's windows() for a file the analyzer reads whole at
    its source rate (the raw route): the stream's length from the sample
    count, the opening window from the start, the ending window from the
    ms-truncated seek to the end."""
    stream_ns = from_secs_f64((samples.size // channels) / rate)
    opening_ns = mul_f32(stream_ns, cfg["opening_window"])
    secs = float(opening_ns // NS) + float(opening_ns % NS) / 1e9
    n_open = int(secs * rate) * channels
    seek_ns = mul_f32(stream_ns, np.float32(1.0) - np.float32(cfg["ending_window"]))
    n_skip = int(((seek_ns // 1_000_000) / 1000.0) * rate) * channels
    return (stream_ns, (samples, n_open, rate, channels),
            (samples[n_skip:], samples.size - n_skip, rate, channels), seek_ns)


def episode_hashes(path, fmt, cfg: dict) -> dict:
    """The analyzer's FrameHashes of one episode: opening and ending hashes
    with their timestamps (ns), the hash duration (ns) and the MD5. `fmt`
    is the season format's module (formats/), whose windows() says what
    the analyzer's route reads of the episode."""
    _, opening, ending, seek_ns = fmt.windows(path, cfg)
    hd_ns = from_secs_f32(np.float32(cfg["hash_duration_s"]))
    step = (hd_ns // 1_000_000) // (ITEM_NS // 1_000_000)
    out = {"hash_duration_ns": hd_ns, "md5": header_md5(path)}
    for side, (seg, nv, rate, channels), offset in (("opening", opening, 0),
                                                    ("ending", ending, seek_ns)):
        raw = lane_hashes(seg, nv, rate, channels)
        kept = raw[::step]
        out[side] = kept
        out[f"{side}_ts"] = _stamps(len(kept), step, offset)
    return out


def needle_dat_bytes(fh: dict) -> bytes:
    """The `.needle.dat` bytes of an episode_hashes() result."""
    parts = [struct.pack("<II", 0, 0)]
    for side in ("opening", "ending"):
        rec = np.zeros(len(fh[side]), _REC)
        rec["h"] = fh[side]
        rec["s"] = fh[f"{side}_ts"] // NS
        rec["n"] = fh[f"{side}_ts"] % NS
        parts += [struct.pack("<Q", len(rec)), rec.tobytes()]
    hd = fh["hash_duration_ns"]
    md5 = fh["md5"].encode()
    parts += [struct.pack("<QI", hd // NS, hd % NS), struct.pack("<Q", len(md5)), md5]
    return b"".join(parts)


def parse_needle_dat(raw: bytes):
    """(opening hashes, ending hashes) of a `.needle.dat`'s bytes, or None
    where they are not of that layout."""
    try:
        pos, out = 8, []
        for _ in range(2):
            (n,) = struct.unpack_from("<Q", raw, pos)
            pos += 8
            out.append(np.frombuffer(raw, _REC, n, pos)["h"].astype(np.uint32))
            pos += n * _REC.itemsize
        return tuple(out)
    except (struct.error, ValueError):
        return None


def parse_skip_file(raw: bytes):
    """{"opening": (f32, f32) or None, "ending": ..., "md5": str} of a skip
    file's bytes, or None where they are not such JSON."""
    try:
        obj = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(obj, dict):
        return None
    pair = (lambda v: None if v is None
            else tuple(np.float32(x) for x in v))
    try:
        return {"opening": pair(obj.get("opening")),
                "ending": pair(obj.get("ending")), "md5": obj.get("md5")}
    except TypeError:
        return None
