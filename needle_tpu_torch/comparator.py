"""Comparator on PyTorch: cross-episode opening/ending search.

Mirrors needle/src/audio/comparator.rs, as needle_tpu/comparator.py does;
this is the port's own copy of it. The pairwise search runs on
`TorchSearchEngine` on the chosen device ('cuda' or 'cpu'), or on the
reference-exact `NumpySearchEngine` (the oracle) when asked for by name;
there is no fallback from one to the other, so a failure on the card
surfaces as an error. Candidate voting, skip files, and display logic run
on host and replicate the reference exactly:

  * pair generation order (comparator.rs:533-545),
  * OpeningAndEndingInfo partitioning (comparator.rs:283-307),
  * find_best_match's distinct-candidate voting with the 1.5x threshold bias
    and the f32 weighted score -(count*0.3 + duration*0.7), with ties broken
    by candidate index — the tuple sort at comparator.rs:456-473,
  * time padding / hash-duration end adjustment (comparator.rs:475-512),
  * skip-file read/write gating (comparator.rs:310-354, 600-624),
  * display output byte-format (comparator.rs:356-381, 596-615).
"""

from __future__ import annotations

import operator as _op
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import constants
from .data import FrameHashes, SkipFile, skip_file_path
from .duration import Duration
from .errors import FrameHashDataNoEnding
from .search.oracle import RunEntry, longest_common_hash_match, popcount_u32
from .util import compute_header_md5sum, format_time


@dataclass
class OpeningAndEndingInfo:
    """Mirror of the reference struct (comparator.rs:47-53)."""

    src_openings: List[RunEntry]
    dst_openings: List[RunEntry]
    src_endings: List[RunEntry]
    dst_endings: List[RunEntry]

    def is_empty(self) -> bool:
        return (
            not self.src_openings
            and not self.dst_openings
            and not self.src_endings
            and not self.dst_endings
        )


@dataclass
class SearchResult:
    """Result for one video (comparator.rs:65-69)."""

    opening: Optional[Tuple[Duration, Duration]] = None
    ending: Optional[Tuple[Duration, Duration]] = None


class NumpySearchEngine:
    """Per-pair reference-exact engine (the oracle)."""

    def search_pair(self, comparator: "Comparator", src: FrameHashes, dst: FrameHashes):
        return comparator._find_opening_and_ending_with(
            src, dst, _lcs_numpy
        )

    def search_pairs(self, comparator, frame_hashes, pairs, threading=True):
        # The reference rayon-parallelizes the pair loop even on CPU
        # (comparator.rs:549-564). numpy releases the GIL inside the DP's
        # vectorized ops, so a thread pool gets real CPU parallelism; the
        # --no-threading kill-switch falls back to the serial loop.
        workers = min(len(pairs), os.cpu_count() or 1)
        if not threading or len(pairs) < 2 or workers < 2:
            return [
                self.search_pair(comparator, frame_hashes[i], frame_hashes[j])
                for (i, j) in pairs
            ]
        from multiprocessing.pool import ThreadPool

        with ThreadPool(workers) as pool:
            return pool.starmap(
                lambda i, j: self.search_pair(
                    comparator, frame_hashes[i], frame_hashes[j]
                ),
                pairs,
            )


def _lcs_numpy(src, src_ts, dst, dst_ts, src_hd, dst_hd, is_opening, cfg):
    return longest_common_hash_match(
        src,
        src_ts,
        dst,
        dst_ts,
        src_hd,
        dst_hd,
        is_opening,
        cfg.hash_match_threshold,
        cfg.min_opening_duration,
        cfg.min_ending_duration,
    )


# Attribute getters for find_best_match's candidate build: the per-entry
# src/dst branch is fixed per match, so bind the accessors once per group
# instead of re-testing is_source for every entry.
_SRC_RUN = _op.attrgetter("src_longest_run")
_SRC_HD = _op.attrgetter("src_hash_duration")
_SRC_MH = _op.attrgetter("src_match_hash")
_DST_RUN = _op.attrgetter("dst_longest_run")
_DST_HD = _op.attrgetter("dst_hash_duration")
_DST_MH = _op.attrgetter("dst_match_hash")


class Comparator:
    """Compares two or more videos using FrameHashes (comparator.rs:73-104),
    searching on a torch device ('cuda' or 'cpu'). `engine="numpy"` selects
    the per-pair oracle engine instead; "auto", the CLI's default, is the
    torch engine."""

    def __init__(self, videos: Sequence = (), device: str = "cuda",
                 engine: str = "torch"):
        if engine not in ("torch", "auto", "numpy"):
            raise ValueError(f"unknown search engine: {engine}")
        self.videos: List[Path] = [Path(v) for v in videos]
        self.include_endings: bool = False
        self.hash_match_threshold: int = constants.DEFAULT_HASH_MATCH_THRESHOLD
        self.min_opening_duration: Duration = Duration.from_secs(
            constants.DEFAULT_MIN_OPENING_DURATION
        )
        self.min_ending_duration: Duration = Duration.from_secs(
            constants.DEFAULT_MIN_ENDING_DURATION
        )
        self.time_padding: Duration = Duration.from_nanos(0)
        self.device = device
        self.engine_name = engine

    # -- builder API mirroring with_* (comparator.rs:106-147) ----------------

    @classmethod
    def from_files(cls, videos: Sequence, **kwargs) -> "Comparator":
        return cls(videos, **kwargs)

    @classmethod
    def from_analyzer(cls, analyzer) -> "Comparator":
        return cls(analyzer.videos, device=analyzer.device)

    def with_include_endings(self, include_endings: bool) -> "Comparator":
        self.include_endings = include_endings
        return self

    def with_hash_match_threshold(self, threshold: int) -> "Comparator":
        self.hash_match_threshold = int(threshold)
        return self

    def with_min_opening_duration(self, d: Duration) -> "Comparator":
        self.min_opening_duration = d
        return self

    def with_min_ending_duration(self, d: Duration) -> "Comparator":
        self.min_ending_duration = d
        return self

    def with_time_padding(self, d: Duration) -> "Comparator":
        self.time_padding = d
        return self

    def _engine(self):
        if self.engine_name == "numpy":
            return NumpySearchEngine()
        # imported here: the engine's module imports this one
        from .search.torch_impl import TorchSearchEngine

        return TorchSearchEngine(self.device)

    # -- core search ----------------------------------------------------------

    def _find_opening_and_ending_with(
        self, src_hashes: FrameHashes, dst_hashes: FrameHashes, lcs
    ) -> OpeningAndEndingInfo:
        """comparator.rs:252-308 with a pluggable LCS kernel."""
        src_hd = src_hashes.hash_duration()
        dst_hd = dst_hashes.hash_duration()

        entries: List[RunEntry] = []
        entries.extend(
            lcs(
                src_hashes.opening_hashes,
                src_hashes.opening_ts_nanos,
                dst_hashes.opening_hashes,
                dst_hashes.opening_ts_nanos,
                src_hd,
                dst_hd,
                True,
                self,
            )
        )
        if self.include_endings:
            if len(src_hashes.ending_hashes) == 0 or len(dst_hashes.ending_hashes) == 0:
                raise FrameHashDataNoEnding()
            entries.extend(
                lcs(
                    src_hashes.ending_hashes,
                    src_hashes.ending_ts_nanos,
                    dst_hashes.ending_hashes,
                    dst_hashes.ending_ts_nanos,
                    src_hd,
                    dst_hd,
                    False,
                    self,
                )
            )

        src_openings, src_endings = [], []
        dst_openings, dst_endings = [], []
        for e in entries:
            if e.is_src_opening:
                src_openings.append(e)
            elif e.is_src_ending:
                src_endings.append(e)
            if e.is_dst_opening:
                dst_openings.append(e)
            elif e.is_dst_ending:
                dst_endings.append(e)
        return OpeningAndEndingInfo(src_openings, dst_openings, src_endings, dst_endings)

    # -- skip files -----------------------------------------------------------

    @staticmethod
    def check_skip_file(video) -> bool:
        """comparator.rs:310-327."""
        sfp = skip_file_path(video)
        if not sfp.exists():
            return False
        md5 = compute_header_md5sum(video)
        skip = SkipFile.read(sfp)
        return skip.md5 == md5

    def create_skip_file(self, video, result: SearchResult) -> None:
        """comparator.rs:329-354."""
        opening = (
            (result.opening[0].as_secs_f32(), result.opening[1].as_secs_f32())
            if result.opening
            else None
        )
        ending = (
            (result.ending[0].as_secs_f32(), result.ending[1].as_secs_f32())
            if result.ending
            else None
        )
        if opening is None and ending is None:
            return
        md5 = compute_header_md5sum(video)
        SkipFile(opening=opening, ending=ending, md5=md5).write(skip_file_path(video))

    # -- display --------------------------------------------------------------

    def display_opening_ending_info(self, result: SearchResult) -> None:
        """comparator.rs:356-381 (exact output bytes, incl. Debug quotes)."""
        if result.opening is not None:
            start, end = result.opening
            print(f'* Opening - "{format_time(start)}"-"{format_time(end)}"')
        else:
            print("* Opening - N/A")
        if self.include_endings:
            if result.ending is not None:
                start, end = result.ending
                print(f'* Ending - "{format_time(start)}"-"{format_time(end)}"')
            else:
                print("* Ending - N/A")

    # -- voting ---------------------------------------------------------------

    def find_best_match(
        self, matches: List[Tuple[OpeningAndEndingInfo, bool]]
    ) -> Optional[SearchResult]:
        """comparator.rs:405-515, reference-exact."""
        if len(matches) == 0:
            return None

        # Candidate columns (match hash / run-duration nanos / is_opening)
        # collected per GROUP, not per entry: a dense library funnels
        # thousands of candidates into each episode's vote. Array-backed
        # groups (the engine's _LazyEntries) contribute column VIEWS
        # without materializing any RunEntry; the winning candidate alone
        # is materialized in pick(). Candidate order is identical to the
        # per-entry walk (matches -> openings, endings -> entries in heap
        # backing order), so the (score, k) tie-break selects the same
        # candidate.
        sims_parts, durs_parts = [], []
        open_flags, group_lens = [], []
        groups_meta = []  # (entries, is_source) per non-empty group
        for m, is_source in matches:
            if is_source:
                groups = ((m.src_openings, True), (m.src_endings, False))
                run_of = _SRC_RUN, _SRC_HD, _SRC_MH
            else:
                groups = ((m.dst_openings, True), (m.dst_endings, False))
                run_of = _DST_RUN, _DST_HD, _DST_MH
            get_run, get_hd, get_mh = run_of
            for entries, is_opening in groups:
                n = len(entries)
                if n == 0:
                    continue
                vc = getattr(entries, "vote_cols", None)
                if vc is not None:
                    s_col, d_col = vc(is_source)
                else:
                    s_col = np.empty(n, np.uint64)
                    d_col = np.empty(n, np.int64)
                    for k, e in enumerate(entries):
                        s_col[k] = get_mh(e)
                        run = get_run(e)
                        # run end >= start always (they delimit a found
                        # run), so plain int math matches Duration.__sub__
                        d_col[k] = run[1]._nanos - run[0]._nanos
                sims_parts.append(s_col)
                durs_parts.append(d_col)
                open_flags.append(is_opening)
                group_lens.append(n)
                groups_meta.append((entries, is_source))

        best = SearchResult()
        if not group_lens:
            # The reference would compute empty vote maps and find no best
            # opening/ending; it still returns Some(default).
            return best

        # Pairwise simhash distance voting (comparator.rs:434-453). dist must
        # be strictly below threshold + threshold/2 (integer division), and a
        # candidate is only ELIGIBLE if at least one pair (including itself)
        # qualified — with threshold 0 nothing enters the reference's
        # distinct-match map and no opening/ending is reported at all.
        # Votes depend only on the simhash VALUES, so the pairwise distance
        # matrix is computed over unique values with multiplicities — exact,
        # and k-squared only in distinct hashes instead of candidates.
        sim = np.concatenate(sims_parts).astype(np.uint32)
        uniq, inv, cnt = np.unique(
            sim, return_inverse=True, return_counts=True
        )
        dist_u = popcount_u32(uniq[:, None] ^ uniq[None, :])
        bias_threshold = self.hash_match_threshold + self.hash_match_threshold // 2
        qualified_u = dist_u < bias_threshold
        votes = (qualified_u * cnt[None, :]).sum(axis=1).astype(np.int64)[inv]
        eligible = qualified_u.any(axis=1)[inv]

        # Reference scoring, vectorized with identical f32 arithmetic:
        # score = -(count as f32 * 0.3f32 + duration_secs * 0.7f32), where
        # duration_secs is Rust Duration::as_secs_f32 (f32 secs + f32
        # subsec / 1e9f32); elementwise np.float32 ops are the same IEEE
        # single-precision operations as the scalar version.
        dur_n = np.concatenate(durs_parts)
        dur_f32 = (dur_n // 1_000_000_000).astype(np.float32) + (
            dur_n % 1_000_000_000
        ).astype(np.float32) / np.float32(1e9)
        score = -(
            votes.astype(np.float32) * np.float32(0.3)
            + dur_f32 * np.float32(0.7)
        )
        glen = np.asarray(group_lens, np.int64)
        is_open_arr = np.repeat(np.asarray(open_flags, bool), glen)
        bases = np.concatenate(([0], np.cumsum(glen)[:-1]))

        def pick(want_opening: bool):
            sel = np.flatnonzero((is_open_arr == want_opening) & eligible)
            if len(sel) == 0:
                return None
            # lexicographic (score, k) minimum, like the reference tuple sort
            idx = int(sel[np.lexsort((sel, score[sel]))[0]])
            g = int(np.searchsorted(bases, idx, side="right")) - 1
            entries, is_source = groups_meta[g]
            k_local = idx - int(bases[g])
            erh = getattr(entries, "entry_run_hd", None)
            if erh is not None:
                (start, end), hash_duration = erh(k_local, is_source)
            else:
                e = entries[k_local]
                if is_source:
                    start, end = _SRC_RUN(e)
                    hash_duration = _SRC_HD(e)
                else:
                    start, end = _DST_RUN(e)
                    hash_duration = _DST_HD(e)
            return (
                start + self.time_padding,
                end - self.time_padding - hash_duration,
            )

        best.opening = pick(True)
        if self.include_endings:
            best.ending = pick(False)
        return best

    # -- top-level runs --------------------------------------------------------

    @staticmethod
    def pair_order(n: int) -> List[Tuple[int, int]]:
        """The reference's pair enumeration (comparator.rs:533-545):
        every unordered pair once, ordered by first appearance."""
        pairs = []
        processed = [False] * n
        for i in range(n):
            for j in range(n):
                if i == j or processed[j]:
                    continue
                pairs.append((i, j))
            processed[i] = True
        return pairs

    def search_pair_infos(
        self,
        frame_hashes: List[FrameHashes],
        pairs: List[Tuple[int, int]],
        threading: bool = True,
    ) -> List[OpeningAndEndingInfo]:
        """Run the search engine over an explicit pair list; the infos are
        finalized with `finalize_results`."""
        from .tracing import span

        engine = self._engine()
        with span("search.pairs", pairs=len(pairs), engine=type(engine).__name__):
            return engine.search_pairs(
                self, frame_hashes, pairs, threading=threading
            )

    def run_with_frame_hashes(
        self,
        frame_hashes: List[FrameHashes],
        display: bool,
        use_skip_files: bool,
        write_skip_files: bool,
        threading: bool = True,
    ) -> List[SearchResult]:
        """comparator.rs:524-629."""
        n = len(self.videos)
        pairs = self.pair_order(n)
        infos = self.search_pair_infos(frame_hashes, pairs, threading)
        data = [
            (i, j, info)
            for (i, j), info in zip(pairs, infos)
            if not info.is_empty()
        ]
        return self.finalize_results(
            data, display, use_skip_files, write_skip_files
        )

    def finalize_results(
        self,
        data: List[Tuple[int, int, OpeningAndEndingInfo]],
        display: bool,
        use_skip_files: bool,
        write_skip_files: bool,
    ) -> List[SearchResult]:
        """Candidate voting, skip files, and display from per-pair infos
        (comparator.rs:567-629). `data` is the non-empty (src, dst, info)
        list."""
        from .tracing import span

        with span("search.finalize", infos=len(data)):
            n = len(self.videos)
            info_map: List[List[Tuple[OpeningAndEndingInfo, bool]]] = [[] for _ in range(n)]
            for src_idx, dst_idx, info in data:
                info_map[src_idx].append((info, True))
                info_map[dst_idx].append((info, False))

            results: List[SearchResult] = []
            for idx, matches in enumerate(info_map):
                path = self.videos[idx]
                if display:
                    print(f"\n{path}\n")

                if use_skip_files and self.check_skip_file(path):
                    if display:
                        print("Skipping due to existing skip file...")
                    continue

                result = self.find_best_match(matches)
                if result is None:
                    if display:
                        if self.include_endings:
                            print("No opening or ending found.")
                        else:
                            print("No opening found.")
                    continue
                if display:
                    self.display_opening_ending_info(result)
                if write_skip_files:
                    self.create_skip_file(path, result)
                results.append(result)

            return results

    def run(
        self,
        analyze: bool,
        display: bool,
        use_skip_files: bool,
        write_skip_files: bool,
        threading: bool = True,
    ) -> List[SearchResult]:
        """comparator.rs:637-663; with analyze=True every video goes
        through this package's Analyzer in one batched pass (force, default
        hash duration, not persisted), on this Comparator's device."""
        from .tracing import pass_span, span

        with pass_span("search", videos=len(self.videos)):
            if analyze:
                from .analyzer import Analyzer

                analyzer = Analyzer(list(self.videos), device=self.device)
                frame_hashes = analyzer.with_force(True).run(
                    Duration.from_secs_f32(constants.DEFAULT_HASH_DURATION),
                    persist=False,
                    threading=threading,
                )
            else:
                with span("search.load", videos=len(self.videos)):
                    frame_hashes = [
                        FrameHashes.from_video(video) for video in self.videos
                    ]
            return self.run_with_frame_hashes(
                frame_hashes, display, use_skip_files, write_skip_files,
                threading
            )
