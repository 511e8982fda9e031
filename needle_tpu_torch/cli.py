"""needle CLI on PyTorch: info / analyze / search.

Mirrors needle/src/main.rs (clap v3 derive), as needle_tpu/cli.py does:
identical subcommands, flag names, defaults, validation messages and
output text, plus `--device {cuda,cpu}` on analyze and search (default
cuda). needle_tpu's extensions keep their meaning: `analyze --backend
numpy|chromaprint` fingerprints on the host, `search --engine numpy` runs
the per-pair oracle engine, and `auto` (the default of both) runs on the
torch device. Their `jax` value is refused with exit code 2.
NEEDLE_TPU_PROFILE=<dir> writes a torch.profiler trace of analyze and of
search there (`tracing.device_profile`).

    python -m needle_tpu_torch.cli analyze --include-endings SEASON_DIR
    python -m needle_tpu_torch.cli search --include-endings SEASON_DIR
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from . import constants
from .analyzer import Analyzer
from .comparator import Comparator
from .duration import Duration
from .errors import Error
from .ingest import IngestError
from .tracing import device_profile
from .util import ffmpeg_version_string, find_video_files


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="needle",
        description=(
            "needle detects openings/intros and endings/credits across video "
            "files (PyTorch/CUDA implementation)."
        ),
    )
    def add_global_flags(parser, suppress: bool):
        # main.rs:178-193: --no-threading/--file-headers-only are
        # clap global=true flags — accepted before OR after the
        # subcommand. Subparser copies default to SUPPRESS so a
        # root-level occurrence isn't clobbered by the subparser.
        kw = {"default": argparse.SUPPRESS} if suppress else {}
        parser.add_argument(
            "--no-threading",
            action="store_true",
            help="Disable multi-threading.",
            **kw,
        )
        parser.add_argument(
            "--file-headers-only",
            action="store_true",
            help=(
                "By default, video files are validated using FFmpeg, which "
                "is extremely accurate. Setting this flag will switch to "
                "just checking file headers."
            ),
            **kw,
        )

    add_global_flags(p, suppress=False)
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser(
        "info", help="Displays info about needle and its dependencies."
    )
    add_global_flags(pi, suppress=True)

    pa = sub.add_parser(
        "analyze",
        help=(
            "Decode one or more video files into a list of frame hashes. The "
            "frame hash data is written to disk alongside each analyzed video "
            "file, and is used by the 'search' command."
        ),
    )
    add_global_flags(pa, suppress=True)
    pa.add_argument("paths", nargs="+", type=Path, help="Video files or directories to analyze.")
    pa.add_argument(
        # main.rs:31: #[clap(short, long, ...)] — the only short alias
        # in the reference CLI
        "-m",
        "--mode",
        choices=["audio"],
        default="audio",
        help="Analysis mode.",
    )
    pa.add_argument(
        "--opening-search-percentage",
        type=float,
        default=constants.DEFAULT_OPENING_SEARCH_PERCENTAGE,
        help="Specifies which portion of the start of the video the opening should be in.",
    )
    pa.add_argument(
        "--ending-search-percentage",
        type=float,
        default=constants.DEFAULT_ENDING_SEARCH_PERCENTAGE,
        help="Specifies which portion of the end of the video the ending should be in.",
    )
    pa.add_argument(
        "--hash-duration",
        type=float,
        default=constants.DEFAULT_HASH_DURATION,
        help="Amount of time (in seconds) that each hash represents.",
    )
    pa.add_argument(
        "--include-endings",
        action="store_true",
        help="If set, needle will also consider endings during the analysis.",
    )
    pa.add_argument(
        "--threaded-decoding",
        action="store_true",
        help="Enable multi-threaded decoding in FFmpeg.",
    )
    pa.add_argument(
        "--force",
        action="store_true",
        help="Re-analyze all videos and ignore any existing hash data on disk.",
    )
    pa.add_argument(
        "--backend",
        choices=["auto", "jax", "numpy", "chromaprint"],
        default="auto",
        help="Fingerprint compute backend (needle-tpu extension).",
    )

    ps = sub.add_parser(
        "search",
        help=(
            "Search for openings and endings among a group of videos using "
            "frame hash data."
        ),
    )
    add_global_flags(ps, suppress=True)
    ps.add_argument(
        "paths", nargs="+", type=Path, help="Video files or directories to search."
    )
    ps.add_argument(
        "--hash-match-threshold",
        type=int,
        default=constants.DEFAULT_HASH_MATCH_THRESHOLD,
        help="Threshold to use when comparing hashes. The range is 0 (exact match) to 32 (no match).",
    )
    ps.add_argument(
        "--min-opening-duration",
        type=int,
        default=constants.DEFAULT_MIN_OPENING_DURATION,
        help="Minimum opening duration, in seconds.",
    )
    ps.add_argument(
        "--min-ending-duration",
        type=int,
        default=constants.DEFAULT_MIN_ENDING_DURATION,
        help="Minimum ending duration, in seconds.",
    )
    ps.add_argument(
        "--time-padding",
        type=float,
        default=constants.DEFAULT_OPENING_AND_ENDING_TIME_PADDING,
        help=(
            "Amount of time (in seconds) to add to detected opening/ending "
            "start time and deduct from detected opening/ending end time."
        ),
    )
    ps.add_argument(
        "--analyze",
        action="store_true",
        help="Run the analysis step in-place instead of looking for pre-computed hash data.",
    )
    ps.add_argument(
        "--use-skip-files",
        action="store_true",
        help="Check skip files on disk during the search.",
    )
    ps.add_argument(
        "--write-skip-files",
        action="store_true",
        help="Write skip files to disk after the search is completed.",
    )
    ps.add_argument(
        "--include-endings",
        action="store_true",
        help="If set, needle will also consider endings during the search.",
    )
    ps.add_argument(
        "--no-display",
        action="store_true",
        help="Do not display results of the search.",
    )
    ps.add_argument(
        "--engine",
        choices=["auto", "jax", "numpy"],
        default="auto",
        help="Search compute engine (needle-tpu extension).",
    )
    for sp in (pa, ps):
        sp.add_argument(
            "--device",
            choices=["cuda", "cpu"],
            default="cuda",
            help="Torch device to run on (needle-tpu-torch extension).",
        )
    return p


def _error_exit(message: str) -> None:
    """clap-style invalid-usage exit (code 2)."""
    print(f"error: {message}", file=sys.stderr)
    sys.exit(2)


def _runtime_error_exit(message: str) -> None:
    """Reference main() returns Result: runtime failures print
    "Error: ..." and exit 1, distinct from usage errors (exit 2)."""
    print(f"Error: {message}", file=sys.stderr)
    sys.exit(1)


def _find_videos(args, paths):
    try:
        return find_video_files(paths, not args.file_headers_only, True)
    except (Error, IngestError) as e:
        _error_exit(str(e))


_metrics_hook_installed = False


def main(argv=None) -> int:
    # INFO log subscriber as in the reference CLI (main.rs:255-259);
    # NEEDLE_TPU_TIMINGS=1 prints per-stage wall times on exit
    from .tracing import install_cli_subscriber, report_metrics

    install_cli_subscriber()
    global _metrics_hook_installed
    if not _metrics_hook_installed:
        import atexit

        atexit.register(report_metrics)
        _metrics_hook_installed = True

    args = _build_parser().parse_args(argv)

    if args.command == "info":
        print(f"FFmpeg version: {ffmpeg_version_string()}")
        return 0

    if args.command == "analyze":
        if args.backend == "jax":
            _error_exit(
                "--backend jax is not supported by needle-tpu-torch; use "
                "--device, or --backend numpy|chromaprint"
            )
        # main.rs:196-241 validation
        if args.opening_search_percentage >= 1.0:
            _error_exit("opening_search_percentage must be less than 1.0")
        if args.ending_search_percentage >= 1.0:
            _error_exit("ending_search_percentage must be less than 1.0")
        if args.hash_duration <= 0.0:
            _error_exit("hash_duration must be greater than 0")
        videos = sorted(_find_videos(args, args.paths))
        analyzer = (
            Analyzer.from_files(
                videos, args.threaded_decoding, args.force,
                device=args.device, backend=args.backend,
            )
            .with_opening_search_percentage(args.opening_search_percentage)
            .with_ending_search_percentage(args.ending_search_percentage)
            .with_include_endings(args.include_endings)
        )
        hash_duration = Duration.from_secs_f32(np.float32(args.hash_duration))
        try:
            with device_profile("needle analyze", args.device):
                analyzer.run(hash_duration, True, not args.no_threading)
        except (Error, IngestError) as e:
            _runtime_error_exit(str(e))
        return 0

    if args.command == "search":
        if args.engine == "jax":
            _error_exit(
                "--engine jax is not supported by needle-tpu-torch; use "
                "--device, or --engine numpy"
            )
        if args.hash_match_threshold < 0 or args.min_opening_duration < 0 \
                or args.min_ending_duration < 0:
            _error_exit("invalid value: thresholds and durations must be non-negative")
        if args.hash_match_threshold > 32:
            _error_exit("hash_match_threshold cannot be larger than 32")
        videos = sorted(_find_videos(args, args.paths))
        if len(videos) < 2:
            _error_exit(
                f"need at least 2 valid video files, but only found "
                f"{len(args.paths)} in provided video paths"
            )
        comparator = (
            Comparator.from_files(videos, device=args.device, engine=args.engine)
            .with_include_endings(args.include_endings)
            .with_hash_match_threshold(args.hash_match_threshold)
            .with_min_opening_duration(Duration.from_secs(args.min_opening_duration))
            .with_min_ending_duration(Duration.from_secs(args.min_ending_duration))
            .with_time_padding(Duration.from_secs_f32(np.float32(args.time_padding)))
        )
        try:
            with device_profile("needle search", args.device):
                comparator.run(
                    args.analyze,
                    not args.no_display,
                    args.use_skip_files,
                    args.write_skip_files,
                    not args.no_threading,
                )
        except (Error, IngestError) as e:
            _runtime_error_exit(str(e))
        return 0

    return 0


def entrypoint() -> None:
    """console_scripts entry point (pyproject.toml)."""
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
