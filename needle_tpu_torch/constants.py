"""Tuning constants, mirroring the reference's defaults exactly.

Reference: needle/src/audio/mod.rs:10-45 and needle/src/lib.rs:154-155.
The port's own copy of needle_tpu/constants.py.
"""

# Default hash match threshold. Two frame hashes "match" when the Hamming
# distance (popcount of XOR) between them is <= this value; range 0 (exact
# match) to 32 (no match). (audio/mod.rs:14)
DEFAULT_HASH_MATCH_THRESHOLD: int = 10

# If a match is found in the first fraction of the video, it is considered an
# opening. (audio/mod.rs:19)
DEFAULT_OPENING_SEARCH_PERCENTAGE: float = 0.50

# If a match is found in the last fraction of the video, it is considered an
# ending. (audio/mod.rs:24)
DEFAULT_ENDING_SEARCH_PERCENTAGE: float = 0.25

# A match is only considered an opening if it runs at least this long
# (seconds). (audio/mod.rs:29)
DEFAULT_MIN_OPENING_DURATION: int = 20

# A match is only considered an ending if it runs at least this long
# (seconds). (audio/mod.rs:34)
DEFAULT_MIN_ENDING_DURATION: int = 20

# Duration of audio (seconds) represented by each stored frame hash.
# (audio/mod.rs:39)
DEFAULT_HASH_DURATION: float = 0.3

# Added to the start time and subtracted from the end time of each detected
# opening/ending. (audio/mod.rs:45)
DEFAULT_OPENING_AND_ENDING_TIME_PADDING: float = 0.0

# On-disk file name suffixes. Note these are applied with Rust
# `Path::with_extension` semantics: the *final* extension of the video path is
# replaced (ep1.mp4 -> ep1.needle.dat). (lib.rs:154-155)
FRAME_HASH_DATA_FILE_NAME: str = "needle.dat"
SKIP_FILE_NAME: str = "needle.skip.json"
