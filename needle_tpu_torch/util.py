"""Utility functions mirroring the reference's `needle::util` module.

Reference: needle/src/util.rs (format_time, is_valid_video_file,
find_video_files, compute_header_md5sum, ffmpeg_version[_string]).
The port's own copy of what it uses of needle_tpu/util.py.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import List, Sequence

from .constants import FRAME_HASH_DATA_FILE_NAME
from .duration import Duration
from .errors import PathNotFound


def format_time(t: Duration) -> str:
    """Format a Duration as "MM:SSs" (util.rs:8-12)."""
    minutes = t.secs // 60
    seconds = t.secs % 60
    return f"{minutes:02}:{seconds:02}s"


def compute_header_md5sum(video) -> str:
    """MD5 of the first 8 KiB of the file (util.rs:99-105).

    Mirrors Rust `read_exact`: raises OSError if the file is shorter than 8 KiB.
    """
    with open(video, "rb") as f:
        buf = f.read(8 * 1024)
    if len(buf) < 8 * 1024:
        raise OSError(f"failed to fill whole buffer reading header of {video}")
    return hashlib.md5(buf).hexdigest()


# ---------------------------------------------------------------------------
# Video-file sniffing (replicates the `infer` crate's is_video header checks,
# used by the reference in --file-headers-only mode; util.rs:33-38)
# ---------------------------------------------------------------------------

_MP4_BRANDS = {
    b"avc1", b"dash", b"iso2", b"iso3", b"iso4", b"iso5", b"iso6",
    b"isom", b"mmp4", b"mp41", b"mp42", b"mp4v", b"mp71", b"MSNV",
    b"NDAS", b"NDSC", b"NDSH", b"NDSM", b"NDSP", b"NDSS", b"NDXC",
    b"NDXH", b"NDXM", b"NDXP", b"NDXS", b"F4V ", b"F4P ",
}


def _is_video_header(buf: bytes) -> bool:
    """Magic-byte video sniff over the first bytes of a file.

    Covers the containers matched by `infer::is_video`: mp4/m4v/mkv/webm/mov/
    avi/wmv/mpeg/flv.
    """
    if len(buf) < 16:
        return False
    # MP4 / M4V / MOV (ftyp box) — only VIDEO brands, like infer::is_video;
    # audio-only (M4A) and image (heic/avif) ISO-BMFF brands are rejected.
    if buf[4:8] == b"ftyp":
        brand = buf[8:12]
        return bool(
            brand in _MP4_BRANDS or brand[:2] == b"qt" or brand == b"M4V "
        )
    # Matroska / WebM (EBML)
    if buf[:4] == b"\x1aE\xdf\xa3":
        return True
    # MOV without ftyp (moov/mdat/free/wide atoms)
    if buf[4:8] in (b"moov", b"mdat", b"free", b"wide", b"pnot", b"skip"):
        return True
    # AVI
    if buf[:4] == b"RIFF" and buf[8:12] == b"AVI ":
        return True
    # WMV/ASF
    if buf[:10] == b"\x30\x26\xb2\x75\x8e\x66\xcf\x11\xa6\xd9":
        return True
    # MPEG-PS / MPEG video
    if buf[:3] == b"\x00\x00\x01" and buf[3] in (0xBA, 0xB3):
        return True
    # FLV
    if buf[:4] == b"FLV\x01":
        return True
    return False


# needle-tpu extension: also accept pre-decoded audio files (.wav/.pcm/.raw)
# as analyzable inputs. The reference requires a video stream (util.rs:22-53),
# so discovery defaults to strict reference semantics; large-scale TPU
# pipelines that feed pre-decoded PCM opt in with NEEDLE_TPU_ALLOW_AUDIO=1
# (read per call, so tests/benches can flip it without reimports).
_AUDIO_ONLY_SUFFIXES = (".wav", ".pcm", ".raw")


def allow_audio_only_files() -> bool:
    # positive opt-in only: any other spelling (including "False", "OFF",
    # "no") keeps strict reference semantics
    return os.environ.get("NEEDLE_TPU_ALLOW_AUDIO", "0").strip().lower() in (
        "1",
        "true",
        "on",
        "yes",
    )


def is_valid_video_file(path, full: bool = True, audio: bool = True) -> bool:
    """Checks if `path` points to a valid video file (util.rs:22-53).

    If `full` is False, only magic bytes of the header are checked (cheap).
    If `full` is True, the container is probed with the native FFmpeg-based
    ingest layer; `audio` additionally requires at least one audio stream.

    Paths ending with "needle.dat" are always rejected.
    """
    path = Path(path)
    if str(path).endswith(FRAME_HASH_DATA_FILE_NAME):
        return False

    if (
        path.suffix.lower() in _AUDIO_ONLY_SUFFIXES
        and allow_audio_only_files()
    ):
        return path.is_file()

    if not full:
        try:
            with open(path, "rb") as f:
                buf = f.read(8192)
        except OSError:
            return False
        return _is_video_header(buf)

    from .ingest import probe

    try:
        info = probe(path)
    except Exception:
        return False
    return info.num_video_streams > 0 and (not audio or info.num_audio_streams > 0)


def find_video_files(paths: Sequence, full: bool = True, audio: bool = True) -> List[Path]:
    """Given files or directories, return the valid video files (util.rs:60-96).

    Only looks one directory level deep, like the reference.
    """
    paths = [Path(p) for p in paths]
    for p in paths:
        if not p.exists():
            raise PathNotFound(p)

    valid: List[Path] = []
    for p in paths:
        if p.is_dir():
            for entry in p.iterdir():
                if is_valid_video_file(entry, full, audio):
                    valid.append(entry)
        else:
            if is_valid_video_file(p, full, audio):
                valid.append(p)
    return valid


def ffmpeg_version() -> int:
    """FFmpeg (libavutil) version integer (util.rs:127-129)."""
    from .ingest import native_ffmpeg_version

    return native_ffmpeg_version()


def ffmpeg_version_string() -> str:
    """FFmpeg version as MAJOR.MINOR.MICRO (util.rs:132-142)."""
    v = ffmpeg_version()
    return f"{v >> 16}.{(v & 0x00FF00) >> 8}.{v & 0xFF}"
