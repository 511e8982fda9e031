"""needle CLI on PyTorch: info / analyze / search.

The argument surface is needle_tpu's (needle_tpu/cli.py, itself the
reference's), plus `--device {cuda,cpu}` on analyze and search (default
cuda). The JAX CLI's `--backend` and `--engine` select JAX-side
implementations and are refused here unless left at their default.

    python -m needle_tpu_torch.cli analyze --include-endings SEASON_DIR
    python -m needle_tpu_torch.cli search --include-endings SEASON_DIR
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from needle_tpu.cli import (
    _build_parser as _base_parser,
    _error_exit,
    _find_videos,
    _runtime_error_exit,
)
from needle_tpu.duration import Duration
from needle_tpu.errors import Error
from needle_tpu.ingest import IngestError
from needle_tpu.util import ffmpeg_version_string

from .analyzer import Analyzer
from .comparator import Comparator


def _build_parser() -> argparse.ArgumentParser:
    p = _base_parser()
    sub = next(
        a for a in p._actions if isinstance(a, argparse._SubParsersAction)
    )
    for name in ("analyze", "search"):
        sub.choices[name].add_argument(
            "--device",
            choices=["cuda", "cpu"],
            default="cuda",
            help="Torch device to run on (needle-tpu-torch extension).",
        )
    return p


_metrics_hook_installed = False


def main(argv=None) -> int:
    # INFO log subscriber as in the reference CLI (main.rs:255-259);
    # NEEDLE_TPU_TIMINGS=1 prints per-stage wall times on exit
    from needle_tpu.tracing import install_cli_subscriber, report_metrics

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
        if args.backend != "auto":
            _error_exit("--backend is not supported by needle-tpu-torch; use --device")
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
                videos, args.threaded_decoding, args.force, device=args.device
            )
            .with_opening_search_percentage(args.opening_search_percentage)
            .with_ending_search_percentage(args.ending_search_percentage)
            .with_include_endings(args.include_endings)
        )
        hash_duration = Duration.from_secs_f32(np.float32(args.hash_duration))
        try:
            analyzer.run(hash_duration, True, not args.no_threading)
        except (Error, IngestError) as e:
            _runtime_error_exit(str(e))
        return 0

    if args.command == "search":
        if args.engine != "auto":
            _error_exit("--engine is not supported by needle-tpu-torch; use --device")
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
            Comparator.from_files(videos, device=args.device)
            .with_include_endings(args.include_endings)
            .with_hash_match_threshold(args.hash_match_threshold)
            .with_min_opening_duration(Duration.from_secs(args.min_opening_duration))
            .with_min_ending_duration(Duration.from_secs(args.min_ending_duration))
            .with_time_padding(Duration.from_secs_f32(np.float32(args.time_padding)))
        )
        try:
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
