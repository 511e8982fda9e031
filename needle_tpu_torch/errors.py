"""Error types mirroring the reference's `needle::Error` enum.

Reference: needle/src/lib.rs:117-152 (enum Error, type Result).

The reference wraps ffmpeg/bincode/serde_json/io/chromaprint errors; here the
native wrapped errors surface as ordinary Python exceptions (OSError,
ValueError, ...) while the needle-specific variants get dedicated classes so
library users can match on them exactly like the Rust enum variants.
The port's own copy of needle_tpu/errors.py.
"""

from pathlib import Path


class Error(Exception):
    """Base error for needle-tpu (reference: needle/src/lib.rs:118)."""


class FrameHashDataNotFound(Error):
    """Frame hash data was not found on disk (lib.rs:120-121)."""

    def __init__(self, path):
        self.path = Path(path)
        super().__init__(f"frame hash data not found at: {str(self.path)!r}")


class FrameHashDataInvalidVersion(Error):
    """Invalid frame hash data version (lib.rs:123-124)."""

    def __init__(self):
        super().__init__("invalid frame hash data version")


class FrameHashDataNoEnding(Error):
    """Frame hash data does not contain ending (lib.rs:126-127)."""

    def __init__(self):
        super().__init__("no ending hash data present")


class AnalyzerMissingPaths(Error):
    """No paths were provided to the Analyzer (lib.rs:129-130)."""

    def __init__(self):
        super().__init__("no paths provided to analyzer")


class PathNotFound(Error):
    """Invalid path (lib.rs:132-133)."""

    def __init__(self, path):
        self.path = Path(path)
        super().__init__(f"path does not exist: {str(self.path)!r}")
