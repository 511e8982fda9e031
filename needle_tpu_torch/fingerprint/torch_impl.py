"""Fingerprinting on PyTorch: port of the device paths of
needle_tpu/fingerprint/jax_impl.py.

Every episode takes one route onto the device, the fused ingest
(`IngestDispatcher`, `fingerprint_ingest_batch`): zero samples past each
lane's valid count -> integer half-band decimation (/2 or /4, exact int32
arithmetic) -> integer downmix -> polyphase windowed-sinc resample to
11025 Hz as one matmul -> the core. Mono i16 already at 11025 Hz
(compressed media, decoded on the host; `fingerprint_batch`) is a lane at
that rate, where decimation and resample do nothing.

The core: 4096-sample frames at hop 1365 -> windowed DFT as two matmuls ->
chroma fold -> 5-tap chroma filter -> L2 normalize -> 16 classifiers as one
matmul -> software log -> 3-threshold quantize -> gray code -> u32
packing, plus per-hash borderline flags: a classifier value (or chroma
norm) within `plan._exact_eps()` of a threshold marks its hash for
recomputation by the canonical host oracle (ingest_oracle.py), so the
returned hashes are exactly the oracle's on every device. Every function
takes the batch (lane) dimension written out where the JAX version used
vmap. Matmuls run in full float32 (`_torch_setup.ensure`); the classifier
values agree with the JAX program's to float32 rounding (summation order
differs), far inside the margin.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

try:
    import resource
except ImportError:  # Windows has no `resource`
    resource = None

from .constants import (
    CHROMA_FILTER_COEFFS,
    CHROMA_NORM_THRESHOLD,
    HOP_SIZE,
    MAX_FILTER_WIDTH,
    SAMPLE_RATE,
)
from .decimate import (
    _HB_MAIN,
    _HB_RELAXED,
    _halfband_q14,
    decimation_factor,
)
from .numpy_impl import (
    downmix_stereo_i16,
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
    gray = _device_gray(q.device)[q]
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


@functools.lru_cache(maxsize=4)
def _device_tables(device: torch.device):
    """(wc, ws, fold, W_cls, thresholds) on `device`, uploaded once."""
    wc, ws, fold = plan._dft_tables()
    W_cls, thresholds = plan._classifier_tables()
    return tuple(
        torch.from_numpy(t).to(device) for t in (wc, ws, fold, W_cls, thresholds)
    )


@functools.lru_cache(maxsize=4)
def _device_gray(device: torch.device) -> torch.Tensor:
    """`_GRAY` on `device`, uploaded once: a table built per call would be a
    blocking copy from the host in the middle of every enqueue."""
    return torch.tensor(_GRAY, dtype=torch.int64, device=device)


class _Slot:
    """A staging buffer: the lanes' int16 samples (flat, read as (LANES,
    in_len) from its start), their LANES int32 valid counts, whether both
    are page-locked, whether a thread is filling it, and the event that
    ends the last upload from it (None on the CPU)."""

    __slots__ = ("raw", "nv", "pinned", "held", "event")

    def __init__(self):
        self.raw = self.nv = self.event = None
        self.pinned = self.held = False


class _StagingRing:
    """The two host buffers that every IngestDispatcher of the process
    stages its lane chunks in, kept across passes: each slot grows to the
    largest chunk staged in it and is page-locked on a card, so a chunk's
    upload runs while the host stages the next one and no pass touches
    fresh pages. A chunk takes the next slot not being filled by another
    thread, or, if there is none, buffers of its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots = [_Slot(), _Slot()]
        self._next = 0

    def take(self):
        """The next free slot, now held by the caller; None if every slot
        is held."""
        with self._lock:
            n = len(self._slots)
            for k in range(n):
                slot = self._slots[(self._next + k) % n]
                if not slot.held:
                    slot.held = True
                    self._next = (self._next + k + 1) % n
                    return slot
        return None

    def release(self, slot, event) -> None:
        """Hand `slot` back; `event` fires once its upload has read it."""
        if slot is not None:
            with self._lock:
                slot.event, slot.held = event, False

    @staticmethod
    def buffers(slot, n: int, pinned: bool):
        """(n int16, LANES int32) host tensors to stage a chunk in, and
        whether `slot` had them already. A slot is waited for until its
        last upload has read it (span ingest.staging_wait), then grown if
        it is too small or not page-locked where `pinned` asks for it;
        without a slot the buffers are new."""
        from ..tracing import span

        if slot is not None:
            with span("ingest.staging_wait"):
                if slot.event is not None:
                    slot.event.synchronize()
            if (slot.raw is not None and slot.raw.numel() >= n
                    and slot.nv.numel() >= LANES
                    and (slot.pinned or not pinned)):
                return slot.raw[:n], slot.nv[:LANES], True
        raw = torch.empty(n, dtype=torch.int16, pin_memory=pinned)
        nv = torch.empty(LANES, dtype=torch.int32, pin_memory=pinned)
        if slot is not None:
            slot.raw, slot.nv, slot.pinned = raw, nv, pinned
        return raw, nv, False


_staging = _StagingRing()


def _mask_frames(x: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """Zero every frame (row of dim 1) at or past each lane's count."""
    frame = torch.arange(x.shape[1], device=x.device)[None, :, None]
    return torch.where(frame < nv[:, None, None], x, 0)


def _source_stage(raw, nv, channels, dec_factor):
    """The source stage: (B, raw_len) int16 interleaved samples, (B,) int32
    valid frame counts -> (B, raw_len // channels // dec_factor) int16 mono
    at the mid rate (exact: every half-band stage clips to the int16 range
    and the downmix halves). Samples past a lane's valid count are zeroed
    before each half-band stage, exactly like the canonical zero padding;
    stereo is downmixed after the decimation."""
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
    return (_downmix(x) if channels == 2 else x[..., 0]).to(torch.int16)


def ingest_fingerprint_batched(
    raw, nv, rs_mat, tables, mid_rate, channels, n_frames, dec_factor=1,
    with_flags=False, with_values=False, source_end=None, mid_out=None,
):
    """Fused pipeline over a batch of lanes: (B, raw_len) int16 interleaved
    samples at mid_rate * dec_factor, (B,) int32 valid frame counts ->
    `_source_stage` -> resample -> `_post_chroma`'s outputs. `source_end`,
    a CUDA event, is recorded once the source stage is enqueued; the
    list `mid_out` receives the source stage's (B, in_len_mid) int16 mono,
    kept on the device for the exact rescan."""
    mono = _source_stage(raw, nv, channels, dec_factor)
    if source_end is not None:
        source_end.record()
    if mid_out is not None:
        mid_out.append(mono)
    mono = mono.to(torch.float32)
    if mid_rate != SAMPLE_RATE:
        mono = _resample(mono, rs_mat, mid_rate, n_frames)
    pad_len = (n_frames + _ROWS_PER_FRAME + 1) * HOP_SIZE
    mono = F.pad(mono, (0, max(0, pad_len - mono.shape[1])))[:, :pad_len]
    return _fingerprint_core(
        mono, *tables, n_frames, with_flags=with_flags,
        with_values=with_values,
    )


def _page_faults():
    """Minor plus major page faults of the calling thread so far, or None
    where `resource` cannot count a thread's: it has RUSAGE_THREAD on Linux
    alone, and Windows has no `resource`."""
    who = getattr(resource, "RUSAGE_THREAD", None)
    if who is None:
        return None
    r = resource.getrusage(who)
    return r.ru_minflt + r.ru_majflt


# each piece of a split lane copy holds at least this many bytes: a chunk
# with fewer valid bytes than two pieces is copied by the staging thread
COPY_PIECE_BYTES = 4 << 20


def _copy_threads() -> int:
    """Threads that share a chunk's lane copy with the staging thread: the
    usable cores less that thread's own, at most LANES; 0 where that leaves
    fewer than two."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity on macOS and Windows
        cores = os.cpu_count() or 1
    n = min(cores - 1, LANES)
    return n if n >= 2 else 0


def _lane_pieces(extents, n: int) -> list:
    """The lanes' [0, extent) ranges laid end to end and cut into n runs of
    near-equal length: for each run, its (lane, start, end) ranges."""
    starts = [0, *itertools.accumulate(extents)]
    bounds = [starts[-1] * k // n for k in range(n + 1)]
    return [[(r, max(lo, s0) - s0, min(hi, s0 + e) - s0)
             for r, (s0, e) in enumerate(zip(starts, extents))
             if max(lo, s0) < min(hi, s0 + e)]
            for lo, hi in zip(bounds, bounds[1:])]


def _copy_piece(buf, lanes, piece):
    """Copy one piece into the (LANES, in_len) `buf`: for each (r, a, b) of
    `piece`, lane r's samples [a, b) from its segment, zeros where they lie
    past it (`lanes[r]` is (segment, samples taken from it)). Returns the
    calling thread's page faults over the copy, or None."""
    faults0 = _page_faults()
    for r, a, b in piece:
        s, take = lanes[r]
        m = min(b, max(a, take))
        buf[r, a:m] = s[a:m]
        buf[r, m:b] = 0
    return None if faults0 is None else _page_faults() - faults0


class _CopyPool:
    """The threads that copy a lane chunk's pieces beside the thread staging
    it, started at first use and kept for the process (like `_staging`):
    NumPy releases the GIL while it copies a piece, so the episodes' pages
    are read on every core at once."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool, self._threads, self._pid = None, 0, None

    def _executor(self):
        with self._lock:
            # a forked child inherits the executor but not its threads
            if self._pid != os.getpid():
                self._threads, self._pid = _copy_threads(), os.getpid()
                self._pool = (ThreadPoolExecutor(
                    self._threads, thread_name_prefix="needle-copy")
                    if self._threads else None)
            return self._pool, self._threads

    def copy(self, buf, lanes, extents, nbytes: int):
        """Copy every lane's [0, extent) into `buf` (`_copy_piece`), split
        into up to one piece a thread, the caller's included, of at least
        COPY_PIECE_BYTES of the `nbytes` valid bytes; below two such
        pieces the caller copies alone. Returns (the copying threads' page
        faults or None, whether the copy was split). Every piece has ended
        when this returns or raises a piece's exception."""
        pool, threads = self._executor()
        n = min(threads + 1, nbytes // COPY_PIECE_BYTES) if pool else 1
        pieces = _lane_pieces(extents, max(n, 1))
        futures = [pool.submit(_copy_piece, buf, lanes, p) for p in pieces[1:]]
        try:
            faults = [_copy_piece(buf, lanes, pieces[0])]
        finally:
            wait(futures)  # no piece may write the slot once it is released
        faults += [f.result() for f in futures]
        return (None if None in faults else sum(faults)), bool(futures)


_copy_pool = _CopyPool()


class IngestDispatcher:
    """Raw-PCM ingest on one device. add() records segments (memmap views
    are fine: no bytes move yet); a chunk of LANES segments of one frame
    bucket is uploaded and dispatched as soon as it fills, and its outputs
    are queued for download. With `threading`, one worker thread collects
    each dispatched chunk and rescans its borderline hashes on the host
    while the caller goes on adding segments; finish() flushes the partial
    chunks to it too, waits for it and returns ref -> uint32 hashes.
    Without it, finish() collects and rescans every chunk itself, in
    order."""

    def __init__(self, in_rate: int, channels: int = 1, device="cuda",
                 threading: bool = True):
        from ..tracing import span

        self.device = resolve_device(device)
        self.in_rate = in_rate
        self.channels = channels
        self.threading = threading
        # the canonical band-limited decimation to >= 8 kHz runs on the
        # device; only factors 2 and 4 have half-band kernels, other rates
        # resample directly
        f = decimation_factor(in_rate)
        self.dec_factor = f if f in (2, 4) else 1
        self.mid_rate = in_rate // self.dec_factor
        with span("ingest.setup"):
            self._rs_mat = torch.from_numpy(
                plan._resample_plan(self.mid_rate)[3]
            ).to(self.device)
            self._tables = _device_tables(self.device)
        self._pending: dict = {}  # nf_bucket -> (refs, [(segment, n_valid)])
        self._chunks: list = []  # (chunk, its worker's future or None)
        self._pool = None  # the worker, started by the first chunk
        # the worker's own stream for fetching rescan windows, so that its
        # copies do not queue behind the chunks dispatched since
        self._fetch_stream = (torch.cuda.Stream(self.device, priority=-1)
                              if self.device.type == "cuda" else None)
        self._out_lens: dict = {}  # ref -> n_sub
        self._empty: dict = {}  # ref -> empty result

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
        refs, segs = self._pending.setdefault(nf_b, ([], []))
        refs.append(ref)
        segs.append((segment, n_valid))
        if len(refs) >= LANES:
            self._dispatch(nf_b)

    def _stage(self, segs, in_len: int):
        """A chunk's (LANES, in_len) lanes and (LANES,) valid counts on the
        device, staged in a slot of the ring (or buffers of its own) and
        copied from there without waiting for the copy."""
        from ..tracing import metrics, span

        cuda = self.device.type == "cuda"
        slot, event = _staging.take(), None
        try:
            with span("ingest.batch_assemble"):
                raw, nv, hit = _staging.buffers(slot, LANES * in_len, cuda)
                metrics.record("ingest.staging_hits" if hit
                               else "ingest.staging_misses", 1.0)
                buf, nv_h = raw.numpy().reshape(LANES, in_len), nv.numpy()
                nv_h[len(segs):] = 0
                lanes, extents = [], []
                for r, (s, n_valid) in enumerate(segs):
                    nv_h[r] = n = min(n_valid, in_len) // self.channels
                    extents.append(n * self.channels)
                    lanes.append((s, min(len(s), extents[-1])))
                copied = sum(take for _, take in lanes) * buf.itemsize
                # only the valid samples are copied and the lane is not
                # cleared: the device zeroes every frame at or past nv, so
                # what an earlier chunk left there is never read. The copy
                # reads the episodes: a memmap's pages fault in here
                with span("ingest.lane_copy"):
                    faults, split = _copy_pool.copy(buf, lanes, extents, copied)
                if faults is not None:
                    metrics.record("ingest.lane_copy_faults", float(faults))
                metrics.record("ingest.lane_bytes", float(copied))
                metrics.record("ingest.lane_copy_pool_bytes",
                               float(copied if split else 0))
                # the source stage's work: the lanes' valid frames in, and
                # the mid-rate mono samples they yield out
                frames = nv_h[: len(segs)].astype(np.int64)
                metrics.record("ingest.source_frames", float(frames.sum()))
                metrics.record("ingest.mid_samples",
                               float((frames // self.dec_factor).sum()))
            with span("ingest.upload"):
                # from page-locked memory the copies are only enqueued; the
                # event hands the slot on once they have read it
                raw_d = raw.view(LANES, in_len).to(
                    self.device, non_blocking=True, copy=True)
                nv_d = nv.to(self.device, non_blocking=True, copy=True)
                if cuda:
                    event = torch.cuda.Event()
                    event.record()
        finally:
            _staging.release(slot, event)
        metrics.record("ingest.upload_bytes", float(buf.nbytes))
        return raw_d, nv_d

    def _dispatch(self, nf_b: int) -> None:
        from ..tracing import carry, span

        refs, segs = self._pending.pop(nf_b)
        _, in_len, _ = plan._ingest_dims(self.mid_rate, nf_b)
        in_len *= self.channels * self.dec_factor
        raw, nv_d = self._stage(segs, in_len)
        with span("ingest.dispatch"):
            # card time of the chunk's kernels and of its source stage, read
            # once its download has been waited for (_collect_and_rescan):
            # no synchronisation here
            kernels = None
            if self.device.type == "cuda":
                kernels = tuple(torch.cuda.Event(enable_timing=True)
                                for _ in range(3))
                kernels[0].record()
            # the source stage's output stays on the device until the
            # worker has fetched the rescan's windows from it
            mid = []
            out = ingest_fingerprint_batched(
                raw, nv_d, self._rs_mat, self._tables, self.mid_rate,
                self.channels, nf_b, self.dec_factor, with_flags=True,
                source_end=kernels[1] if kernels else None, mid_out=mid,
            )
            if kernels:
                kernels[2].record()
            lanes = [(ref, self._out_lens[ref]) for ref in refs]
            chunk = (lanes, nf_b, mid, *self._download(out), kernels)
            future = None
            if self.threading:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="needle-rescan")
                future = self._pool.submit(
                    carry(self._collect_and_rescan), *chunk)
        self._chunks.append((chunk, future))

    def _download(self, out):
        """(hashes, flag_rows, event): on a card, the outputs' copy into
        pinned host memory, enqueued behind the chunk's kernels, and the
        event that marks its end; on the CPU the outputs as they are. (A
        blocking copy made later from the worker would also wait for every
        chunk dispatched after this one.)"""
        if self.device.type != "cuda":
            return (*out, None)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in out]
        event = torch.cuda.Event()
        event.record()
        return (*host, event)

    def _collect_and_rescan(self, lanes, nf_b, mid, hashes, flag_rows,
                            event, kernels) -> dict:
        """One chunk's ref -> uint32 hashes: its outputs cut to each lane's
        n_sub, the borderline-flagged ones recomputed with the canonical
        host oracle from the mid-rate windows of the chunk's source stage
        output, the one tensor in the list `mid`, which is emptied. On a
        card, `event` ends the chunk's download and `kernels` are the
        events at the start of its kernels, at the end of its source stage
        and at the end of its kernels (counters ingest.decimate_card_s and
        ingest.kernels_card_s)."""
        from ..tracing import metrics, span

        from .ingest_oracle import ingest_hashes_mid_oracle, rescan_mid_rows

        with span("ingest.collect"):
            if event is not None:
                event.synchronize()
                start, source_end, end = kernels
                metrics.record("ingest.kernels_card_s",
                               start.elapsed_time(end) / 1e3)
                metrics.record("ingest.decimate_card_s",
                               start.elapsed_time(source_end) / 1e3)
            hashes = hashes.numpy()
            flag_rows = flag_rows.numpy()
            results, flags = {}, []
            for r, (ref, n) in enumerate(lanes):
                results[ref] = hashes[r, :n].astype(np.uint32)
                flags.append(flag_rows[r, :n])
        total = sum(int(f.sum()) for f in flags)
        metrics.record("ingest.rescan_hashes", float(total))
        source = mid.pop()
        if not total:
            return results
        with span("ingest.rescan", flagged=total):
            # lane row -> its merged flagged ranges
            ranges = {r: merge_flag_ranges(np.nonzero(f)[0])
                      for r, f in enumerate(flags) if f.any()}
            rows = [(r, g_lo, g_hi) for r, rs in ranges.items()
                    for g_lo, g_hi in rescan_mid_rows(self.mid_rate, nf_b, rs)]
            with span("ingest.rescan_fetch"):
                windows = iter(self._fetch_windows(
                    source, rows, kernels[1] if kernels else None))
                del source  # the device memory goes once fetched
            with span("ingest.rescan_oracle"):
                for r, rs in ranges.items():
                    outs = ingest_hashes_mid_oracle(
                        [next(windows) for _ in rs], self.mid_rate, nf_b, rs)
                    ref = lanes[r][0]
                    for (lo, hi), o in zip(rs, outs):
                        results[ref][lo:hi] = o
        return results

    def _fetch_windows(self, mid, rows, source_end) -> list:
        """Rows [g_lo, g_hi) of lane r of `mid`, the chunk's (LANES,
        in_len_mid) int16 source stage output, for each (r, g_lo, g_hi) of
        `rows`, as int16 host arrays; rows before 0 or past the lane are
        zeros. On a card they are gathered on the worker's own stream,
        behind the chunk's source stage (`source_end`), and brought to
        page-locked memory in one copy, waited for here; on the CPU the
        same slices are taken directly. Counters
        ingest.rescan_window_bytes and ingest.rescan_card_windows."""
        from ..tracing import metrics

        offs = np.cumsum([0] + [g_hi - g_lo for _, g_lo, g_hi in rows])
        n_mid = mid.shape[1]
        stream = self._fetch_stream
        cuda = stream is not None
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            if cuda:
                stream.wait_event(source_end)
            flat = torch.zeros(int(offs[-1]), dtype=torch.int16,
                               device=mid.device)
            for (r, g_lo, g_hi), o in zip(rows, offs):
                a, b = max(g_lo, 0), min(g_hi, n_mid)
                if b > a:
                    flat[o + a - g_lo : o + b - g_lo] = mid[r, a:b]
            if cuda:
                host = torch.empty(flat.shape, dtype=torch.int16,
                                   pin_memory=True)
                host.copy_(flat, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
        if cuda:
            done.synchronize()
            flat = host
        metrics.record("ingest.rescan_window_bytes",
                       float(flat.numel() * flat.element_size()))
        metrics.record("ingest.rescan_card_windows", float(len(rows)))
        flat = flat.numpy()
        return [flat[o : o + g_hi - g_lo]
                for (_, g_lo, g_hi), o in zip(rows, offs)]

    def finish(self) -> dict:
        """Flush partial chunks, collect everything. Returns ref->hashes;
        an error in the worker is raised here."""
        from ..tracing import span

        results = dict(self._empty)
        try:
            for nf_b in list(self._pending):
                self._dispatch(nf_b)
            with span("ingest.rescan_wait"):
                for chunk, future in self._chunks:
                    results.update(self._collect_and_rescan(*chunk)
                                   if future is None else future.result())
        finally:
            if self._pool is not None:
                self._pool.shutdown(cancel_futures=True)
            self._pool, self._chunks, self._pending, self._empty = (
                None, [], {}, {})
        return results


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


def fingerprint_batch(monos: Sequence[np.ndarray], device="cuda") -> List[np.ndarray]:
    """Fingerprint a batch of mono i16 episodes at 11025 Hz on `device`
    (port of fingerprint_jax_batch): the fused ingest at the core's rate,
    where no resample runs and the lanes are the samples themselves. The
    returned hashes are exactly fingerprint_numpy's."""
    return fingerprint_ingest_batch(monos, SAMPLE_RATE, 1, device=device)


def fingerprint(mono_i16: np.ndarray, device="cuda") -> np.ndarray:
    """mono i16 at 11025 Hz -> u32 subfingerprints, computed on `device`."""
    return fingerprint_batch([mono_i16], device)[0]


def fingerprint_stereo(interleaved_i16: np.ndarray, device="cuda") -> np.ndarray:
    """Stereo interleaved i16 at 11025 Hz -> subfingerprints (downmix on
    the host, with C truncation semantics)."""
    return fingerprint(downmix_stereo_i16(interleaved_i16), device)


def classifier_values(mono_i16: np.ndarray, device="cuda"):
    """The pre-quantization classifier values (n_sub, 16) and per-frame
    chroma norms of one mono 11025 Hz segment, computed by the production
    program on `device` (port of classifier_values_jax), for comparison
    with the float64 oracle against the borderline margin."""
    mono = np.asarray(mono_i16, dtype=np.int16)
    nf = num_frames(len(mono))
    if nf <= 0:
        return np.zeros((0, 16), np.float32), np.zeros((0,), np.float32)
    values, norms, _, _ = ingest_classifier_values(mono, SAMPLE_RATE, 1,
                                                   device=device)
    # the norms of the frames the segment has, not of its frame bucket
    return values, norms[: max(0, nf - (len(CHROMA_FILTER_COEFFS) - 1))]
