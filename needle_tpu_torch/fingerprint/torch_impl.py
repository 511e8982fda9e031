"""Fused fingerprint ingest on PyTorch: port of the raw-PCM device path of
needle_tpu/fingerprint/jax_impl.py.

One batched program per lane chunk, on the chosen device:

  zero samples past each lane's valid count -> integer half-band
  decimation (/2 or /4, exact int32 arithmetic) -> integer downmix ->
  polyphase windowed-sinc resample to 11025 Hz as one matmul -> 4096-sample
  frames at hop 1365 -> windowed DFT as two matmuls -> chroma fold ->
  5-tap chroma filter -> L2 normalize -> 16 classifiers as one matmul ->
  software log -> 3-threshold quantize -> gray code -> u32 packing,

plus per-hash borderline flags: a classifier value (or chroma norm) within
`plan._exact_eps()` of a threshold marks its hash for recomputation by the
canonical host oracle (ingest_oracle.py), so the returned hashes are
exactly the oracle's on every device. Every function takes the batch (lane)
dimension written out where the JAX version used vmap. Matmuls run in full
float32 (`_torch_setup.ensure`); the classifier values agree with the JAX
program's to float32 rounding (summation order differs), far inside the
margin.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from needle_tpu.fingerprint.constants import (
    CHROMA_FILTER_COEFFS,
    CHROMA_NORM_THRESHOLD,
    HOP_SIZE,
    MAX_FILTER_WIDTH,
    SAMPLE_RATE,
)
from needle_tpu.fingerprint.decimate import (
    _HB_MAIN,
    _HB_RELAXED,
    _halfband_q14,
    decimation_factor,
)
from needle_tpu.fingerprint.numpy_impl import (
    merge_flag_ranges,
    num_frames,
    num_subfingerprints,
)

from .._torch_setup import resolve_device
from . import plan
from .plan import LANES, _FRAME_REMAINDER, _ROWS_PER_FRAME, bucket_frames


def _f32(v) -> float:
    """A Python float holding exactly the float32 value of v, so that torch
    applies the same constant the JAX program does."""
    return float(np.float32(v))


# musl logf's split of ln 2: HI has zeroed low mantissa bits so
# exponent * LN2_HI is exact in f32
_LN2_HI = _f32(6.9313812256e-01)
_LN2_LO = _f32(9.0580006145e-06)
_SQRT2_F32 = _f32(1.4142135)
_NORM_THRESHOLD = _f32(CHROMA_NORM_THRESHOLD)


def _accurate_log32(x: torch.Tensor) -> torch.Tensor:
    """~2-ulp float32 natural log for strictly-positive normal x
    (needle_tpu/fingerprint/jax_impl.py::_accurate_log32): x = m * 2^e with
    m in [sqrt(1/2), sqrt(2)), log(m) = 2 atanh(t), t = (m-1)/(m+1), by a
    5-term odd series, recombined with ln 2 split hi/lo."""
    bits = x.view(torch.int32)
    # (bits >> 23) & 0x1FF is the unsigned shift of the JAX version
    e = ((bits >> 23) & 0x1FF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > _SQRT2_F32
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int32)
    t = (m - 1.0) / (m + 1.0)
    t2 = t * t
    p = _f32(1.0 / 9.0) * t2 + _f32(1.0 / 7.0)
    p = p * t2 + _f32(1.0 / 5.0)
    p = p * t2 + _f32(1.0 / 3.0)
    p = p * t2 + 1.0
    ef = e.to(torch.float32)
    return ef * _LN2_HI + (2.0 * t * p + ef * _LN2_LO)


def _frames_from_padded(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, T) f32 signal (padded so the rows exist) -> (B, n_frames, 4096):
    frame f is hop rows f, f+1, f+2 and the first sample of row f+3."""
    B = x.shape[0]
    n_rows = n_frames + _ROWS_PER_FRAME
    rows = x[:, : n_rows * HOP_SIZE].reshape(B, n_rows, HOP_SIZE)
    return torch.cat(
        [
            rows[:, :n_frames],
            rows[:, 1 : n_frames + 1],
            rows[:, 2 : n_frames + 2],
            rows[:, 3 : n_frames + 3, :_FRAME_REMAINDER],
        ],
        dim=2,
    )


def _pack_bits(gray: torch.Tensor) -> torch.Tensor:
    """(..., 16) gray codes -> (...,) int64 holding the u32 hash; packing in
    int64 because gray << 30 overflows int32. The 2-bit fields are
    disjoint, so their sum is their OR."""
    shifts = 2 * (15 - torch.arange(16, device=gray.device))
    return (gray.to(torch.int64) << shifts).sum(dim=-1)


_GRAY = (0, 1, 3, 2)


def _post_chroma(chroma, W_cls, thresholds, n_frames, with_flags=False,
                 with_values=False, eps=None):
    """(B, n_frames, 12) chroma -> filter -> normalize -> classifiers ->
    (B, n_sub) int64 hashes, with (B, n_sub) bool borderline flags when
    with_flags; with_values returns (values (B, n_sub, 16), chroma norms
    (B, n_filt)) instead."""
    n_filt = n_frames - (len(CHROMA_FILTER_COEFFS) - 1)
    filtered = torch.zeros_like(chroma[:, :n_filt])
    for k, coeff in enumerate(CHROMA_FILTER_COEFFS):
        filtered = filtered + _f32(coeff) * chroma[:, k : k + n_filt]
    norm = torch.sqrt(torch.sum(filtered * filtered, dim=2, keepdim=True))
    normalized = torch.where(
        norm < _NORM_THRESHOLD,
        0.0,
        filtered / torch.where(norm == 0, 1.0, norm),
    )
    n_sub = n_filt - (MAX_FILTER_WIDTH - 1)
    windows = torch.cat(
        [normalized[:, k : k + n_sub] for k in range(MAX_FILTER_WIDTH)], dim=2
    )
    ab = torch.matmul(windows, W_cls)
    a, b = ab[..., 0::2], ab[..., 1::2]
    values = _accurate_log32((1.0 + a) / (1.0 + b))
    if with_values:
        return values, norm[..., 0]
    q = (
        (values >= thresholds[:, 0]).to(torch.int64)
        + (values >= thresholds[:, 1]).to(torch.int64)
        + (values >= thresholds[:, 2]).to(torch.int64)
    )
    gray = torch.tensor(_GRAY, dtype=torch.int64, device=q.device)[q]
    hashes = _pack_bits(gray)
    if not with_flags:
        return hashes
    eps = _f32(plan._exact_eps() if eps is None else eps)
    # classifier-value margin: min over (16 classifiers x 3 thresholds)
    margin = torch.amin(
        torch.abs(values[..., None] - thresholds), dim=(-2, -1)
    )
    flag_val = margin < eps
    # norm-zeroing margin: normalized frame j feeds subfingerprints
    # j-15..j, so OR the per-frame flag over each 16-frame window
    flag_norm = torch.abs(norm[..., 0] - _NORM_THRESHOLD) < eps
    flag_norm_w = flag_norm[:, :n_sub]
    for k in range(1, MAX_FILTER_WIDTH):
        flag_norm_w = flag_norm_w | flag_norm[:, k : k + n_sub]
    return hashes, flag_val | flag_norm_w


def _fingerprint_core(mono, wc, ws, fold, W_cls, thresholds, n_frames,
                      with_flags=False, with_values=False):
    """(B, T) f32 samples at 11025 Hz -> hashes (see _post_chroma). The
    windowed DFT restricted to the chroma bins is two matmuls against the
    (4096, bins) cos/sin tables."""
    frames = _frames_from_padded(mono, n_frames)
    re = torch.matmul(frames, wc)
    im = torch.matmul(frames, ws)
    chroma = torch.matmul(re * re + im * im, fold)
    return _post_chroma(
        chroma, W_cls, thresholds, n_frames, with_flags=with_flags,
        with_values=with_values,
    )


def _decimate2_hb_i32(x: torch.Tensor, odd_q, c0: int) -> torch.Tensor:
    """(B, n, C) int32 -> (B, n//2, C) int32: exact replica of the native
    half-band decimator (zero-padded edges, Q14 taps, (acc + 8192) >> 14
    arithmetic shift, clip to the i16 range). Every tap offset has fixed
    parity, so the stride-2 reads are unit-stride slices of an even/odd
    deinterleaved view."""
    B, n, C = x.shape
    H = 2 * len(odd_q) - 1
    out_n = n // 2
    pad_top = H + 1  # even: keeps every offset's parity fixed
    pad_bot = H + 1 + ((pad_top + n + H + 1) % 2)  # total length even
    xp = F.pad(x, (0, 0, pad_top, pad_bot))
    de = xp.reshape(B, -1, 2, C)
    even, odd = de[:, :, 0], de[:, :, 1]

    def sl(offset):
        """x[2k + offset] for k in [0, out_n), as a unit-stride slice."""
        o = offset + pad_top
        src = even if o % 2 == 0 else odd
        return src[:, o // 2 : o // 2 + out_n]

    acc = int(c0) * sl(0)
    for m, q in enumerate(odd_q):
        d = 2 * m + 1
        acc = acc + int(q) * (sl(-d) + sl(d))
    return torch.clamp((acc + 8192) >> 14, -32768, 32767)


def _resample(flat: torch.Tensor, rs_mat: torch.Tensor, in_rate: int,
              n_frames: int) -> torch.Tensor:
    """(B, in_len) f32 at in_rate -> (B, out_needed) f32 at 11025 Hz: each
    block of k*M inputs plus a 2H margin times the (k*M + 2H, k*L) filter
    matrix gives the block's k*L outputs."""
    L, M, k, _ = plan._resample_plan(in_rate)
    H = plan._RS_HALF_TAPS
    n_blocks, _, out_needed = plan._ingest_dims(in_rate, n_frames)
    B = flat.shape[0]
    kM = k * M
    # left-pad by H so the first outputs see their full filter support and
    # output sample i lands exactly at input time i*M/L
    flat = F.pad(flat, (H, 0))
    rows = flat[:, : n_blocks * kM].reshape(B, n_blocks, kM)
    margin = flat[:, kM : kM + n_blocks * kM].reshape(B, n_blocks, kM)
    windows = torch.cat([rows, margin[..., : 2 * H]], dim=2)
    out = torch.matmul(windows, rs_mat).reshape(B, -1)
    return out[:, :out_needed]


def _downmix(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) int32 stereo frames -> (...) int32 mono with chromaprint's
    semantics: (l + r) / 2 truncated toward zero."""
    s = x[..., 0] + x[..., 1]
    return torch.where(s < 0, -((-s) >> 1), s >> 1)


def _mask_frames(x: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """Zero every frame (row of dim 1) at or past each lane's count."""
    frame = torch.arange(x.shape[1], device=x.device)[None, :, None]
    return torch.where(frame < nv[:, None, None], x, 0)


def ingest_fingerprint_batched(
    raw, nv, rs_mat, tables, mid_rate, channels, n_frames, dec_factor=1,
    with_flags=False, with_values=False,
):
    """Fused pipeline over a batch of lanes: (B, raw_len) int16 interleaved
    samples at mid_rate * dec_factor, (B,) int32 valid frame counts ->
    `_post_chroma`'s outputs. Samples past a lane's valid count are zeroed
    before the decimation FIR, exactly like the canonical zero padding."""
    B = raw.shape[0]
    x = _mask_frames(raw.reshape(B, -1, channels).to(torch.int32), nv)
    if dec_factor > 1:
        nv1 = nv
        if dec_factor == 4:
            x = _decimate2_hb_i32(x, *_halfband_q14(*_HB_RELAXED))
            nv1 = nv1 // 2
            x = _mask_frames(x, nv1)
        x = _decimate2_hb_i32(x, *_halfband_q14(*_HB_MAIN))
        x = _mask_frames(x, nv1 // 2)
    mono = (_downmix(x) if channels == 2 else x[..., 0]).to(torch.float32)
    if mid_rate != SAMPLE_RATE:
        mono = _resample(mono, rs_mat, mid_rate, n_frames)
    pad_len = (n_frames + _ROWS_PER_FRAME + 1) * HOP_SIZE
    mono = F.pad(mono, (0, max(0, pad_len - mono.shape[1])))[:, :pad_len]
    return _fingerprint_core(
        mono, *tables, n_frames, with_flags=with_flags,
        with_values=with_values,
    )


class IngestDispatcher:
    """Raw-PCM ingest on one device. add() records segments (memmap views
    are fine: no bytes move yet); a chunk of LANES segments of one frame
    bucket is uploaded and dispatched as soon as it fills; finish() flushes
    partial chunks, downloads every output, rescans the borderline hashes
    on the host and returns ref -> uint32 hashes."""

    def __init__(self, in_rate: int, channels: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.in_rate = in_rate
        self.channels = channels
        # the canonical band-limited decimation to >= 8 kHz runs on the
        # device; only factors 2 and 4 have half-band kernels, other rates
        # resample directly
        f = decimation_factor(in_rate)
        self.dec_factor = f if f in (2, 4) else 1
        self.mid_rate = in_rate // self.dec_factor
        self._rs_mat = torch.from_numpy(
            plan._resample_plan(self.mid_rate)[3]
        ).to(self.device)
        wc, ws, fold = plan._dft_tables()
        W_cls, thresholds = plan._classifier_tables()
        self._tables = tuple(
            torch.from_numpy(t).to(self.device)
            for t in (wc, ws, fold, W_cls, thresholds)
        )
        self._pending: dict = {}  # nf_bucket -> (refs, [(segment, n_valid)])
        self._launched: list = []  # (refs, device outputs)
        self._out_lens: dict = {}  # ref -> n_sub
        self._empty: dict = {}  # ref -> empty result
        # the rescan needs each lane's raw segment again
        self._rescan_info: dict = {}  # ref -> (segment, n_valid, nf_bucket)

    def lane_geometry(self, n_valid: int):
        """(n_sub, frame bucket) of a segment with n_valid interleaved
        samples."""
        n_dec = (n_valid // self.channels) // self.dec_factor
        n_res = plan.resampled_length(
            n_dec * self.channels, self.mid_rate, self.channels
        )
        return num_subfingerprints(n_res), bucket_frames(num_frames(n_res))

    def add(self, ref, segment: np.ndarray, n_valid: int = None) -> None:
        """Queue one segment. `segment` may extend past the true window;
        `n_valid` is the window's interleaved sample count (default: all of
        it). Samples past n_valid are treated as zeros."""
        segment = np.asarray(segment, dtype=np.int16)
        if n_valid is None:
            n_valid = len(segment)
        n_sub, nf_b = self.lane_geometry(n_valid)
        if n_sub <= 0:
            self._empty[ref] = np.zeros(0, np.uint32)
            return
        self._out_lens[ref] = n_sub
        self._rescan_info[ref] = (segment, n_valid, nf_b)
        refs, segs = self._pending.setdefault(nf_b, ([], []))
        refs.append(ref)
        segs.append((segment, n_valid))
        if len(refs) >= LANES:
            self._dispatch(nf_b)

    def _dispatch(self, nf_b: int) -> None:
        from needle_tpu.tracing import metrics, span

        refs, segs = self._pending.pop(nf_b)
        _, in_len, _ = plan._ingest_dims(self.mid_rate, nf_b)
        in_len *= self.channels * self.dec_factor
        with span("ingest.batch_assemble"):
            # only the valid samples are copied; the rest of the lane is
            # zeros, which is what the device mask would make of it
            buf = np.zeros((LANES, in_len), np.int16)
            nv = np.zeros(LANES, np.int32)
            for r, (s, n_valid) in enumerate(segs):
                nv[r] = min(n_valid, in_len) // self.channels
                take = min(len(s), int(nv[r]) * self.channels)
                buf[r, :take] = s[:take]
        with span("ingest.upload"):
            raw = torch.from_numpy(buf).to(self.device)
            nv_d = torch.from_numpy(nv).to(self.device)
        metrics.record("ingest.upload_bytes", float(buf.nbytes))
        with span("ingest.dispatch"):
            out = ingest_fingerprint_batched(
                raw, nv_d, self._rs_mat, self._tables, self.mid_rate,
                self.channels, nf_b, self.dec_factor, with_flags=True,
            )
        self._launched.append((refs, out))

    def finish(self) -> dict:
        """Flush partial chunks, collect everything. Returns ref->hashes."""
        from needle_tpu.tracing import span

        for nf_b in list(self._pending):
            self._dispatch(nf_b)
        results = dict(self._empty)
        flags = {}
        with span("ingest.collect"):
            for refs, (hashes, flag_rows) in self._launched:
                hashes = hashes.cpu().numpy()
                flag_rows = flag_rows.cpu().numpy()
                for r, ref in enumerate(refs):
                    n = self._out_lens[ref]
                    results[ref] = hashes[r, :n].astype(np.uint32)
                    flags[ref] = flag_rows[r, :n]
        self._rescan(results, flags)
        self._launched, self._pending, self._empty = [], {}, {}
        self._rescan_info = {}
        return results

    def _rescan(self, results: dict, flags: dict) -> None:
        """Recompute borderline-flagged hashes with the canonical host
        oracle, in place."""
        from needle_tpu.tracing import span

        from .ingest_oracle import ingest_hashes_ranges_oracle

        total = sum(int(f.sum()) for f in flags.values())
        if not total:
            return
        with span("ingest.rescan", flagged=total):
            for ref, f in flags.items():
                if not f.any():
                    continue
                segment, n_valid, nf_b = self._rescan_info[ref]
                ranges = merge_flag_ranges(np.nonzero(f)[0])
                outs = ingest_hashes_ranges_oracle(
                    segment, n_valid, self.in_rate, self.channels,
                    self.dec_factor, nf_b, ranges,
                )
                for (lo, hi), o in zip(ranges, outs):
                    results[ref][lo:hi] = o


def fingerprint_ingest_batch(
    segments: Sequence[np.ndarray], in_rate: int, channels: int = 1,
    n_valids: Sequence[int] = None, device="cuda",
) -> List[np.ndarray]:
    """Fingerprint raw-PCM segments (i16 at in_rate, interleaved if stereo)
    on `device`; hashes are exactly the canonical oracle's. `n_valids`
    gives each segment's true sample count when it extends past its
    window."""
    if not segments:
        return []
    d = IngestDispatcher(in_rate, channels, device)
    for idx, s in enumerate(segments):
        d.add(idx, s, None if n_valids is None else n_valids[idx])
    results = d.finish()
    return [results[i] for i in range(len(segments))]


def ingest_classifier_values(
    segment_i16: np.ndarray, in_rate: int, channels: int = 1,
    n_valid: int = None, device="cuda",
):
    """Pre-quantization classifier values and chroma norms of ONE lane,
    computed by the production program on `device`, for comparison with
    ingest_oracle.ingest_values_oracle. Returns (values (n_sub, 16), norms,
    dec_factor, frame bucket)."""
    segment = np.asarray(segment_i16, dtype=np.int16)
    if n_valid is None:
        n_valid = len(segment)
    d = IngestDispatcher(in_rate, channels, device)
    n_sub, nf_b = d.lane_geometry(n_valid)
    _, in_len, _ = plan._ingest_dims(d.mid_rate, nf_b)
    in_len *= channels * d.dec_factor
    buf = np.zeros((1, in_len), np.int16)
    buf[0, : min(len(segment), in_len)] = segment[:in_len]
    nv = np.asarray([min(n_valid, in_len) // channels], np.int32)
    values, norms = ingest_fingerprint_batched(
        torch.from_numpy(buf).to(d.device), torch.from_numpy(nv).to(d.device),
        d._rs_mat, d._tables, d.mid_rate, channels, nf_b, d.dec_factor,
        with_values=True,
    )
    return (
        values[0, :n_sub].cpu().numpy(),
        norms[0].cpu().numpy(),
        d.dec_factor,
        nf_b,
    )
