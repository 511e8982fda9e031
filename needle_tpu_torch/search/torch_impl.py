"""All-pairs search engine on PyTorch: port of needle_tpu's JaxSearchEngine.

For each side (openings, then endings) of a library:

  1. The episode hash table is uploaded once; pairs gather their rows
     from it on the device.
  2. Flagged (pair, diagonal) items come from one of four routes, tried in
     needle_tpu's order (search/prefilter.py; `search.prefilter` span):
       - direct: for 2048+ pairs dense in episode space, the block
         correlation flags candidate diagonals and no count walk runs;
       - band: otherwise the correlation gives each pair row-block masks,
         pairs with an all-zero mask are dropped, and the count walk skips
         the cleared blocks;
       - pair: for buckets too long for a 31-bit mask, pairs whose maximum
         correlation is under the bound are dropped;
       - walk-all: below 2048 pairs (or with the prefilter off) every pair
         is walked with all-ones masks.
     The count walk (search/diag_runs.py: the CUDA kernel on a card, its
     plain version on the CPU) counts, per pair and diagonal, the run ends
     with run >= a conservative hash-count bound l_min, and
     `torch.nonzero(counts > 0)` lists the flagged items in row-major
     order.
  3. Extraction recomputes each flagged diagonal's match vector, takes run
     lengths from one cummax over run starts, and keeps the top K_CANDS
     run ends; a diagonal with more ends is rescanned exactly on the host.
  4. The host assembles RunEntry lists in reference order
     (search/host.py), which `Comparator.find_best_match` votes over.

Every route is exact: the prefilter only skips pairs, blocks or diagonals
that provably hold no run of l_min cells.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .._shapes import size_bucket as _bucket
from .._torch_setup import resolve_device
from ..errors import FrameHashDataNoEnding
from .diag_runs import (
    D_TILE,
    batch_counts,
    full_block_mask,
    n_groups_for,
    popcount32,
)
from .host import _diag_candidates, _entries_batch, _EpisodeSide
from .oracle import RunEntry
from .prefilter import direct_diag_items, prefilter_band_masks, prefilter_pairs

# Pairs per count-walk launch.
CHUNK = 1024
# Flagged diagonals per extraction step.
EXTRACT_CHUNK = 4096
# Run ends kept per flagged diagonal by the device extraction; a diagonal
# with more is rescanned on the host.
K_CANDS = 8

_INT32_MAX = np.iinfo(np.int32).max


def _extract_batch(table, nv_tab, tpad, ia, ib, off, lm, threshold, n_pad):
    """Device extraction of run-end candidates for flagged diagonals
    (needle_tpu/search/jax_impl.py::_batch_extract_candidates).

    Item k reads row ia[k] of `table` against the diagonal j = i + off[k]
    of row ib[k], read as a shifted slice of the zero-padded (e_pad,
    3*n_pad) table `tpad`. Returns (end_i (items, K_CANDS), run lengths
    (items, K_CANDS), number of run ends (items,)), unused slots -1/0.
    Keeping only runs >= l_min is exact: a shorter run spans less than the
    minimum duration, which the later timestamp filter would drop."""
    dev = table.device
    idx = torch.arange(n_pad, device=dev)
    nv, mv = nv_tab[ia][:, None], nv_tab[ib][:, None]
    j = idx[None, :] + off[:, None]
    hs = table[ia]
    hd = tpad[ib[:, None], n_pad + j]
    valid = (idx[None, :] >= 1) & (idx[None, :] < nv) & (j >= 1) & (j < mv)
    S = (popcount32(hs ^ hd) <= threshold) & valid
    # run length from one scan: cummax over run-start positions gives the
    # start of the current run at every cell (S[:, 0] is always False,
    # since valid cells have i >= 1)
    S_prev = torch.cat([torch.zeros_like(S[:, :1]), S[:, :-1]], dim=1)
    starts = torch.where(S & ~S_prev, idx[None, :], -1)
    latest_start = torch.cummax(starts, dim=1).values
    run = torch.where(S, idx[None, :] - latest_start + 1, 0)
    S_next = torch.cat([S[:, 1:], torch.zeros_like(S[:, :1])], dim=1)
    ends = S & ~S_next & (run >= lm.clamp(min=1)[:, None])
    score = torch.where(ends, idx[None, :] + 1, 0)
    end_i = torch.topk(score, K_CANDS, dim=1).values - 1  # -1 = unused slot
    runs = torch.where(
        end_i >= 0, torch.gather(run, 1, end_i.clamp(min=0)), 0
    )
    return end_i, runs, ends.sum(dim=1)


class TorchSearchEngine:
    """Batched all-pairs search on one torch device ('cuda' or 'cpu')."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _search_side(
        self,
        comparator,
        sides: List[_EpisodeSide],
        hash_durations,
        pairs: List[Tuple[int, int]],
        is_opening: bool,
    ) -> Dict[int, List[RunEntry]]:
        from ..tracing import metrics, span

        dev = self.device
        threshold = int(comparator.hash_match_threshold)
        min_dur = (
            comparator.min_opening_duration
            if is_opening
            else comparator.min_ending_duration
        )
        min_dur_ns = min_dur.total_nanos()

        results: Dict[int, List[RunEntry]] = {p: [] for p in range(len(pairs))}
        work = [
            (p, a, b)
            for p, (a, b) in enumerate(pairs)
            if len(sides[a].hashes) and len(sides[b].hashes)
        ]
        if not work:
            return results

        # episode table: every episode of the work list, uploaded once;
        # hashes as int32 bit patterns, lengths carry the validity
        ep_ids = sorted({a for _, a, _ in work} | {b for _, _, b in work})
        ep_slot = {e: s for s, e in enumerate(ep_ids)}
        n_pad = _bucket(max(len(sides[e].hashes) for e in ep_ids))
        n_pad = -(-n_pad // D_TILE) * D_TILE  # kernel rows are 512-wide
        e_pad = _bucket(len(ep_ids))
        table = np.zeros((e_pad, n_pad), np.uint32)
        nv_tab = np.zeros(e_pad, np.int32)
        for e, s in ep_slot.items():
            h = sides[e].hashes
            table[s, : len(h)] = h
            nv_tab[s] = len(h)
        table_d = torch.from_numpy(table.view(np.int32)).to(dev)
        nv_d = torch.from_numpy(nv_tab).to(dev)

        # l_min per pair (cells): conservative run-length bound from the
        # minimum duration and each side's maximum hash spacing
        ceil_ep = np.ones(len(sides), np.int64)
        for e in ep_ids:
            ceil_ep[e] = -(-min_dur_ns // sides[e].max_spacing)
        pre_a = np.fromiter((a for _, a, _ in work), np.int64, len(work))
        pre_b = np.fromiter((b for _, _, b in work), np.int64, len(work))
        pre_lm = np.minimum(np.maximum(ceil_ep[pre_a], ceil_ep[pre_b]), _INT32_MAX)
        pair_lm = dict(zip((p for p, _, _ in work), pre_lm.tolist()))

        # the prefilter routes (module docstring); a pair the prefilter
        # drops keeps its empty entry list
        idx = torch.arange(n_pad, device=dev)
        vtab_d = (idx[None, :] >= 1) & (idx[None, :] < nv_d[:, None])
        band_masks = None
        n_skipped = 0
        with span("search.prefilter", work=len(work)):
            direct_items = direct_diag_items(
                table_d, vtab_d, work, ep_slot, pair_lm.__getitem__,
                threshold, n_pad,
            )
            if direct_items is None:
                work, band_masks, n_skipped, _ = prefilter_band_masks(
                    table_d, vtab_d, work, ep_slot, pair_lm.__getitem__,
                    threshold, n_pad,
                )
            if direct_items is None and band_masks is None:
                work, n_skipped, _ = prefilter_pairs(
                    table_d, vtab_d, work, ep_slot, pair_lm.__getitem__,
                    threshold, n_pad,
                )
        if direct_items is not None:
            metrics.record("search.direct_items", float(len(direct_items[0])))
        if n_skipped:
            metrics.record("search.prefilter_skipped", float(n_skipped))

        n_work = len(work)
        w_pidx = np.fromiter((p for p, _, _ in work), np.int64, n_work)
        w_a = np.fromiter((a for _, a, _ in work), np.int64, n_work)
        w_b = np.fromiter((b for _, _, b in work), np.int64, n_work)
        w_sa = np.fromiter((ep_slot[a] for a in w_a.tolist()), np.int32, n_work)
        w_sb = np.fromiter((ep_slot[b] for b in w_b.tolist()), np.int32, n_work)
        w_lm = np.fromiter((pair_lm[p] for p in w_pidx.tolist()), np.int32, n_work)

        if direct_items is not None:
            item_rows, item_offs = direct_items
        else:
            item_rows, item_offs = self._walk(
                w_sa, w_sb, w_lm, band_masks, table_d, nv_d, threshold,
                n_pad, is_opening,
            )

        with span("search.extract", items=len(item_rows)):
            cand_row, cand_i, cand_j, cand_L = self._extract_candidates(
                item_rows, item_offs, w_sa, w_sb, w_lm, w_a, w_b,
                sides, table_d, nv_d, threshold, n_pad,
            )
        with span("search.entries", cands=len(cand_row)):
            _entries_batch(
                results, cand_row, cand_i, cand_j, cand_L,
                w_pidx, w_sa, w_sb, w_a, w_b, ep_ids, sides,
                hash_durations, is_opening, min_dur_ns, n_pad, e_pad,
            )
        return results

    def _walk(self, w_sa, w_sb, w_lm, band_masks, table_d, nv_d, threshold,
              n_pad, is_opening):
        """Count walk over the work rows in chunks; band_masks (rows,
        n_groups) int32 or None for all-ones. Returns the flagged (work
        row, diagonal offset) items as device int64 tensors."""
        from ..tracing import span

        dev = table_d.device
        n_work = len(w_sa)
        # chunk sizes are powers of two, padded with lanes that walk nothing
        chunk = 1
        while chunk < n_work and chunk < CHUNK:
            chunk *= 2
        n_groups = n_groups_for(n_pad)
        full = full_block_mask(n_pad)
        thr_d = torch.full((chunk,), threshold, dtype=torch.int32, device=dev)
        d_base = -(n_pad - 1)
        rows_parts = [torch.zeros(0, dtype=torch.int64, device=dev)]
        offs_parts = [torch.zeros(0, dtype=torch.int64, device=dev)]
        with span(
            "search.walk", side="opening" if is_opening else "ending",
            work=n_work, chunk=chunk, n_pad=n_pad,
        ):
            for c0 in range(0, n_work, chunk):
                n_b = min(chunk, n_work - c0)
                # padding lanes: episode slot 0, an unreachable run bound
                # and mask 0, so they can never produce candidates
                ia = np.zeros(chunk, np.int32)
                ib = np.zeros(chunk, np.int32)
                lm = np.full(chunk, _INT32_MAX, np.int32)
                bm = np.zeros((chunk, n_groups), np.int32)
                ia[:n_b] = w_sa[c0 : c0 + n_b]
                ib[:n_b] = w_sb[c0 : c0 + n_b]
                lm[:n_b] = w_lm[c0 : c0 + n_b]
                bm[:n_b] = full if band_masks is None else band_masks[c0 : c0 + n_b]
                ia_d = torch.from_numpy(ia).to(dev)
                ib_d = torch.from_numpy(ib).to(dev)
                counts = batch_counts(
                    nv_d[ia_d], nv_d[ib_d], torch.from_numpy(lm).to(dev),
                    thr_d, table_d[ia_d], table_d[ib_d], n_pad,
                    bm=torch.from_numpy(bm).to(dev),
                )
                flagged = torch.nonzero(counts > 0)  # row-major (row, d)
                rows_parts.append(flagged[:, 0] + c0)
                offs_parts.append(flagged[:, 1] + d_base)
        return torch.cat(rows_parts), torch.cat(offs_parts)

    def _extract_candidates(
        self, item_rows, item_offs, w_sa, w_sb, w_lm, w_a, w_b,
        sides, table_d, nv_d, threshold, n_pad,
    ):
        """Flagged (work row, diagonal offset) device items -> exact
        (cand_row, cand_i, cand_j, cand_L) int64 host arrays, cand_row
        indexing the work list. Diagonals with more than K_CANDS run ends
        are rescanned on the host (_diag_candidates)."""
        empty = np.zeros(0, np.int64)
        if len(item_rows) == 0:
            return empty, empty, empty, empty
        dev = table_d.device
        tpad = torch.nn.functional.pad(table_d, (n_pad, n_pad))
        sa_d = torch.from_numpy(w_sa).to(dev)
        sb_d = torch.from_numpy(w_sb).to(dev)
        lm_d = torch.from_numpy(w_lm).to(dev)
        outs = []
        for c0 in range(0, len(item_rows), EXTRACT_CHUNK):
            rows = item_rows[c0 : c0 + EXTRACT_CHUNK]
            outs.append(
                _extract_batch(
                    table_d, nv_d, tpad, sa_d[rows], sb_d[rows],
                    item_offs[c0 : c0 + EXTRACT_CHUNK], lm_d[rows],
                    threshold, n_pad,
                )
            )
        end_i = torch.cat([o[0] for o in outs]).cpu().numpy().astype(np.int64)
        runs = torch.cat([o[1] for o in outs]).cpu().numpy().astype(np.int64)
        n_ends = torch.cat([o[2] for o in outs]).cpu().numpy()
        rows = item_rows.cpu().numpy().astype(np.int64)
        offs = item_offs.cpu().numpy().astype(np.int64)

        rs, ks = np.nonzero((end_i >= 0) & (n_ends <= K_CANDS)[:, None])
        row_parts = [rows[rs]]
        i_parts = [end_i[rs, ks]]
        j_parts = [end_i[rs, ks] + offs[rs]]
        L_parts = [runs[rs, ks]]
        # pathological diagonals (more run ends than K_CANDS): exact host
        # rescan
        for r in np.flatnonzero(n_ends > K_CANDS).tolist():
            row, off = int(rows[r]), int(offs[r])
            cands = _diag_candidates(
                sides[w_a[row]].hashes, sides[w_b[row]].hashes, off, threshold
            )
            if cands:
                arr = np.asarray(cands, np.int64)
                row_parts.append(np.full(len(arr), row, np.int64))
                i_parts.append(arr[:, 0])
                j_parts.append(arr[:, 1])
                L_parts.append(arr[:, 2])
        return (
            np.concatenate(row_parts),
            np.concatenate(i_parts),
            np.concatenate(j_parts),
            np.concatenate(L_parts),
        )

    def search_pairs(self, comparator, frame_hashes, pairs, threading=True):
        """Engine entry point used by Comparator.run_with_frame_hashes.
        `threading` is accepted for engine-interface parity; the device
        batch is already parallel across pairs."""
        # imported here: comparator.py imports this module's package
        from ..comparator import OpeningAndEndingInfo

        hash_durations = [fh.hash_duration() for fh in frame_hashes]
        # validate ending data before any device work
        if comparator.include_endings:
            for a, b in pairs:
                if (
                    len(frame_hashes[a].ending_hashes) == 0
                    or len(frame_hashes[b].ending_hashes) == 0
                ):
                    raise FrameHashDataNoEnding()

        open_sides = [
            _EpisodeSide(fh.opening_hashes, fh.opening_ts_nanos)
            for fh in frame_hashes
        ]
        open_entries = self._search_side(
            comparator, open_sides, hash_durations, pairs, True
        )
        end_entries: Dict[int, List[RunEntry]] = {}
        if comparator.include_endings:
            end_sides = [
                _EpisodeSide(fh.ending_hashes, fh.ending_ts_nanos)
                for fh in frame_hashes
            ]
            end_entries = self._search_side(
                comparator, end_sides, hash_durations, pairs, False
            )

        # entries carry uniform flags per side (openings all is_*_opening,
        # endings all is_*_ending), so the reference's per-entry regrouping
        # reduces to placing each side's whole list in both src and dst
        # slots; nothing downstream mutates the lists
        empty: List[RunEntry] = []
        return [
            OpeningAndEndingInfo(
                open_entries.get(p, empty),
                open_entries.get(p, empty),
                end_entries.get(p, empty),
                end_entries.get(p, empty),
            )
            for p in range(len(pairs))
        ]
