"""The comparison that decides `correct`: what the timed passes wrote and
returned, held against the plain reference (`reference/`).

Every number is a count of answers that differ, so every limit is 0:

  dat_files_wrong   episodes whose `.needle.dat` is not byte for byte the
                    reference's (hashes, timestamps, hash duration, MD5)
  hashes_wrong      hashes in those files that differ from the reference's
                    (a missing or unreadable file counts all of its own)
  pairs_wrong       pairs whose RunEntry lists, as the last search
                    returned them, differ from the reference's count
  skip_files_wrong  episodes whose skip file differs from the reference's
                    vote (present or not, each time, the MD5)

`planted_misses` (episodes whose skip file's opening or ending is not
within the tolerance of the planted one) is reported beside them and
decides nothing: the reference's own votes miss on some seasons.
"""

from __future__ import annotations

from pathlib import Path

from .reference.files import needle_dat_bytes, parse_needle_dat, parse_skip_file
from .traffic import output_path

LIMITS = {"dat_files_wrong": 0, "hashes_wrong": 0, "pairs_wrong": 0,
          "skip_files_wrong": 0}


def snapshot_outputs(paths) -> dict:
    """The bytes of every `.needle.dat` and skip file (None where missing)."""
    def read(p):
        return p.read_bytes() if p.exists() else None

    return {key: [read(output_path(Path(p), step)) for p in paths]
            for key, step in (("dat", "analyze"), ("skip", "search"))}


def info_entries(info):
    """A search's OpeningAndEndingInfo as (opening, ending) tuples in the
    reference's layout, or None where its src and dst views disagree."""
    def keys(entries):
        return [(e.score, *(d.total_nanos() for d in e.src_longest_run),
                 *(d.total_nanos() for d in e.dst_longest_run),
                 e.src_match_hash, e.dst_match_hash, e.is_src_opening,
                 e.is_src_ending, e.is_dst_opening, e.is_dst_ending,
                 e.src_hash_duration.total_nanos(),
                 e.dst_hash_duration.total_nanos()) for e in entries]

    op, en = keys(info.src_openings), keys(info.src_endings)
    if keys(info.dst_openings) != op or keys(info.dst_endings) != en:
        return None
    return op, en


def searched_entries(last: dict) -> dict:
    """(i, j) -> entries of the last search's infos."""
    if not last:
        return {}
    return {tuple(ij): info_entries(info)
            for ij, info in zip(last["pairs"], last["infos"])}


def compare(outputs: dict, searched: dict, ref: dict) -> dict:
    """The numbers above, of the outputs (snapshot_outputs) and the
    searched entries (searched_entries)."""
    dat_wrong = hashes_wrong = skip_wrong = 0
    for k, fh in enumerate(ref["episodes"]):
        got = outputs["dat"][k]
        if got != needle_dat_bytes(fh):
            dat_wrong += 1
            held = None if got is None else parse_needle_dat(got)
            for side, ours in zip(("opening", "ending"), held or (None, None)):
                theirs = fh[side]
                if ours is None or len(ours) != len(theirs):
                    hashes_wrong += max(len(theirs), 0 if ours is None else len(ours))
                else:
                    hashes_wrong += int((ours != theirs).sum())
    for k, want in enumerate(ref["skip"]):
        raw = outputs["skip"][k]
        got = None if raw is None else parse_skip_file(raw)
        if want is None:
            skip_wrong += raw is not None
        elif (got is None or got["opening"] != want["opening"]
              or got["ending"] != want["ending"]
              or got["md5"] != ref["episodes"][k]["md5"]):
            skip_wrong += 1
    pairs_wrong = sum(searched.get(tuple(ij)) != tuple(map(list, want))
                      for ij, want in zip(ref["pairs"], ref["entries"]))
    return {"dat_files_wrong": dat_wrong, "hashes_wrong": hashes_wrong,
            "pairs_wrong": pairs_wrong, "skip_files_wrong": skip_wrong}


def planted_misses(outputs: dict, truth, tol_s: float) -> int:
    """Episodes whose skip file misses the planted opening or ending
    ((start, end) per episode, None where there is no ending) by tol_s."""
    def near(got, want):
        return got is not None and all(abs(float(g) - w) < tol_s for g, w in zip(got, want))

    misses = 0
    for raw, (opening, ending) in zip(outputs["skip"], truth):
        got = None if raw is None else parse_skip_file(raw)
        misses += not (got is not None and near(got["opening"], opening)
                       and (ending is None or near(got["ending"], ending)))
    return misses
