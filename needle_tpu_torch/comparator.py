"""Comparator on PyTorch: needle_tpu's Comparator with the torch engine.

Voting, skip files and display are the base class's, unchanged. The search
engine is always `TorchSearchEngine` on the chosen device: there is no
fallback to another engine, so a failure on the card surfaces as an error.
"""

from __future__ import annotations

from typing import List, Sequence

from needle_tpu.comparator import Comparator as _BaseComparator
from needle_tpu.comparator import SearchResult
from needle_tpu.constants import DEFAULT_HASH_DURATION
from needle_tpu.data import FrameHashes
from needle_tpu.duration import Duration

from .search.torch_impl import TorchSearchEngine


class Comparator(_BaseComparator):
    """Compares two or more videos using FrameHashes, searching on a torch
    device ('cuda' or 'cpu')."""

    def __init__(self, videos: Sequence = (), device: str = "cuda"):
        super().__init__(videos, engine="torch")
        self.device = device

    @classmethod
    def from_analyzer(cls, analyzer) -> "Comparator":
        return cls(analyzer.videos, device=analyzer.device)

    def _engine(self):
        return TorchSearchEngine(self.device)

    def run(
        self,
        analyze: bool,
        display: bool,
        use_skip_files: bool,
        write_skip_files: bool,
        threading: bool = True,
    ) -> List[SearchResult]:
        """comparator.rs:637-663; with analyze=True every video goes
        through this package's Analyzer (force, default hash duration, not
        persisted)."""
        if analyze:
            from .analyzer import Analyzer

            analyzer = Analyzer(list(self.videos), device=self.device)
            frame_hashes = analyzer.with_force(True).run(
                Duration.from_secs_f32(DEFAULT_HASH_DURATION),
                persist=False,
                threading=threading,
            )
        else:
            frame_hashes = [
                FrameHashes.from_video(video) for video in self.videos
            ]
        return self.run_with_frame_hashes(
            frame_hashes, display, use_skip_files, write_skip_files, threading
        )
