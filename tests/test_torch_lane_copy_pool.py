"""The fused ingest's split lane copy (needle_tpu_torch/fingerprint/
torch_impl.py::_CopyPool), on the CPU: a chunk's copy into its staging slot
cut into pieces by byte range over the lanes' valid samples, run on a pool
of threads beside the staging thread.

The slot must hold exactly what the serial copy leaves there, whatever the
pieces' bounds; a chunk under two pieces is copied inline; a piece's error
reaches the caller with every piece ended and the slot handed back; and
`ingest.lane_copy_faults` counts every copying thread's faults."""

import threading

import numpy as np
import pytest

from needle_tpu_torch.fingerprint import ingest_oracle as O
from needle_tpu_torch.fingerprint import torch_impl as T
from needle_tpu_torch.tracing import metrics

PIECE = 64 << 10


def _noise(rng, n, amp=6000):
    return (rng.standard_normal(n) * amp).astype(np.int16)


@pytest.fixture
def pool(monkeypatch):
    """A fresh ring and copy pool, four lanes a chunk, three copy threads
    beside the caller and 64 KiB pieces."""
    monkeypatch.setattr(T, "LANES", 4)
    monkeypatch.setattr(T, "_staging", T._StagingRing())
    fresh = T._CopyPool()
    monkeypatch.setattr(T, "_copy_pool", fresh)
    monkeypatch.setattr(T, "_copy_threads", lambda: 3)
    monkeypatch.setattr(T, "COPY_PIECE_BYTES", PIECE)
    return fresh


def _serial(monkeypatch):
    """Swap in a copy pool with no threads: every copy runs inline."""
    monkeypatch.setattr(T, "_copy_pool", T._CopyPool())
    monkeypatch.setattr(T, "_copy_threads", lambda: 0)


def _counted(name, before):
    return metrics.snapshot().get(name, (0.0, 0))[0] - before.get(name, (0.0, 0))[0]


def _pieces(monkeypatch):
    """Spy on _copy_piece: the list of (thread name, piece) it is called with."""
    seen, real = [], T._copy_piece

    def spy(buf, lanes, piece):
        seen.append((threading.current_thread().name, piece))
        return real(buf, lanes, piece)

    monkeypatch.setattr(T, "_copy_piece", spy)
    return seen


# (rate, channels, [(segment seconds or samples, n_valid or None)])
CASES = {
    # three lanes of four
    "partial": (16000, 1, [(20, None), (12, None), (25, None)]),
    # n_valid of an odd count of samples: the last half frame is dropped
    "stereo_odd_n_valid": (44100, 2, [(7, 44100 * 2 * 7 - 1), (9, 44100 * 2 * 6 + 1)]),
    # the samples between the segment's end and n_valid are zeros
    "segment_shorter_than_n_valid": (16000, 1, [(12, 16000 * 20), (25, None)]),
    # a whole file's memmap with the window's n_valid
    "segment_longer_than_in_len": (16000, 1, [(200, 16000 * 20), (90, 16000 * 11)]),
    # stereo lanes whose pieces start and end inside a frame
    "mid_frame_bounds": (48000, 2, [(6, 48000 * 2 * 5 + 6), (3, 48000 * 2 * 3 - 2),
                                    (4, 48000 * 2 * 4 - 6)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_copy_leaves_the_serial_copy_s_bytes(pool, monkeypatch, case):
    rate, channels, spec = CASES[case]
    rng = np.random.default_rng(len(case))
    segs = [(_noise(rng, rate * channels * s), nv) for s, nv in spec]
    segs = [(s, len(s) if nv is None else nv) for s, nv in segs]
    d = T.IngestDispatcher(rate, channels, "cpu")
    nf_b = max(d.lane_geometry(nv)[1] for _, nv in segs)
    _, in_len, _ = T.plan._ingest_dims(d.mid_rate, nf_b)
    in_len *= channels * d.dec_factor
    if case == "segment_longer_than_in_len":
        assert all(len(s) > in_len for s, _ in segs)

    seen = _pieces(monkeypatch)
    before = metrics.snapshot()
    raw, nv = d._stage(segs, in_len)
    pieces = [p for _, p in seen]
    assert len(pieces) == 4 and {t for t, _ in seen} > {"MainThread"}
    copied = _counted("ingest.lane_bytes", before)
    assert _counted("ingest.lane_copy_pool_bytes", before) == copied > 0
    if case == "mid_frame_bounds":
        inner = [x for p in pieces for _, a, b in p for x in (a, b)]
        assert any(x % channels for x in inner)

    _serial(monkeypatch)
    before = metrics.snapshot()
    raw1, nv1 = d._stage(segs, in_len)
    assert len(seen) == 5 and seen[-1][0] == "MainThread"
    assert _counted("ingest.lane_copy_pool_bytes", before) == 0
    assert _counted("ingest.lane_bytes", before) == copied

    np.testing.assert_array_equal(nv.numpy(), nv1.numpy())
    want_copied = 0
    for r, (s, n_valid) in enumerate(segs):
        n = min(n_valid, in_len) // channels
        ext, take = n * channels, min(len(s), n * channels)
        assert nv[r] == n
        want = np.concatenate([s[:take], np.zeros(ext - take, np.int16)])
        np.testing.assert_array_equal(raw[r, :ext].numpy(), want)
        np.testing.assert_array_equal(raw1[r, :ext].numpy(), want)
        want_copied += 2 * take
    assert copied == want_copied
    assert nv[len(segs):].tolist() == [0] * (4 - len(segs))


def _oracle(seg, rate, channels, n_valid=None):
    d = T.IngestDispatcher(rate, channels, "cpu")
    n_valid = len(seg) if n_valid is None else n_valid
    n_sub, nf_b = d.lane_geometry(n_valid)
    return O.ingest_hashes_full_oracle(seg, n_valid, rate, channels,
                                       d.dec_factor, nf_b, n_sub)


def _dispatch(segs, rate, channels, n_valids=None):
    d = T.IngestDispatcher(rate, channels, "cpu")
    for i, s in enumerate(segs):
        d.add(i, s, None if n_valids is None else n_valids[i])
    out = d.finish()
    return [out[i] for i in range(len(segs))]


@pytest.mark.parametrize("rate,channels", [(16000, 1), (44100, 2)])
def test_hashes_after_louder_chunks(pool, rate, channels):
    """Two chunks of full-scale noise through both slots, then quieter
    lanes (a partial chunk, one segment shorter than its n_valid) split
    across the pool: each equals the canonical whole-lane oracle."""
    rng = np.random.default_rng(rate)
    _dispatch([_noise(rng, rate * channels * 25, 30000) for _ in range(8)],
              rate, channels)
    assert all(slot.raw is not None for slot in T._staging._slots)
    segs = [_noise(rng, rate * channels * s) for s in (20, 11, 23)]
    n_valids = [len(segs[0]), rate * channels * 16, len(segs[2])]
    before = metrics.snapshot()
    got = _dispatch(segs, rate, channels, n_valids)
    assert _counted("ingest.lane_copy_pool_bytes", before) == _counted(
        "ingest.lane_bytes", before) > 2 * PIECE
    for g, s, nv in zip(got, segs, n_valids):
        np.testing.assert_array_equal(g, _oracle(s, rate, channels, nv))


def test_a_chunk_under_two_pieces_stays_inline(pool, monkeypatch):
    seen = _pieces(monkeypatch)
    seg = _noise(np.random.default_rng(4), PIECE - 2)  # 4 bytes short of two pieces
    before = metrics.snapshot()
    got = _dispatch([seg], 16000, 1)[0]
    assert [t for t, _ in seen] == ["MainThread"]
    assert _counted("ingest.lane_bytes", before) == 2 * PIECE - 4
    assert _counted("ingest.lane_copy_pool_bytes", before) == 0
    assert metrics.snapshot()["ingest.lane_copy_pool_bytes"][1] > before.get(
        "ingest.lane_copy_pool_bytes", (0.0, 0))[1]
    np.testing.assert_array_equal(got, _oracle(seg, 16000, 1))
    assert pool._pool is not None  # started, and not used


@pytest.mark.parametrize("where", ["pool", "caller"])
def test_a_piece_s_error_reaches_finish(pool, monkeypatch, where):
    """A piece that raises, on a pool thread or on the caller's: finish()
    raises it once every piece has ended, no slot is left held, and the
    next dispatcher stages through the same ring and pool."""
    real, ended = T._copy_piece, []
    # the caller copies the piece at lane 0's start; a pool thread the one
    # at lane 1's
    target = (0, 0) if where == "caller" else (1, 0)

    def failing(buf, lanes, piece):
        if piece[0][:2] == target:
            raise RuntimeError("piece failed")
        out = real(buf, lanes, piece)
        ended.append(piece)
        return out

    monkeypatch.setattr(T, "_copy_piece", failing)
    rng = np.random.default_rng(8)
    segs = [_noise(rng, 16000 * 20) for _ in range(2)]
    d = T.IngestDispatcher(16000, 1, "cpu")
    for i, s in enumerate(segs):
        d.add(i, s)
    with pytest.raises(RuntimeError, match="piece failed"):
        d.finish()
    assert len(ended) == 3
    assert not any(slot.held for slot in T._staging._slots)
    assert d._pool is None and d._chunks == [] and d._pending == {}
    monkeypatch.setattr(T, "_copy_piece", real)
    for g, s in zip(_dispatch(segs, 16000, 1), segs):
        np.testing.assert_array_equal(g, _oracle(s, 16000, 1))


def test_faults_are_every_piece_s_own(pool, monkeypatch):
    """Each piece counts its own thread's faults, and the counter is their
    sum: a clock of faults per thread that every reading advances by one."""
    clocks = threading.local()

    def faults():
        clocks.n = getattr(clocks, "n", 0) + 1
        return clocks.n

    monkeypatch.setattr(T, "_page_faults", faults)
    seen = _pieces(monkeypatch)
    rng = np.random.default_rng(2)
    segs = [_noise(rng, 16000 * 20) for _ in range(3)]
    before = metrics.snapshot()
    _dispatch(segs, 16000, 1)
    assert len(seen) == 4
    assert _counted("ingest.lane_copy_faults", before) == 4


def test_faults_of_fresh_mappings_on_every_thread(pool, monkeypatch, tmp_path):
    """With the kernel's own counts (RUSAGE_THREAD): four lanes, each a
    fresh mapping of a file of its own and each one piece, so every
    copying thread faults on its first read; the counter is the sum of the
    pieces' counts."""
    resource = pytest.importorskip("resource")
    if not hasattr(resource, "RUSAGE_THREAD"):
        pytest.skip("this platform counts no thread's faults")
    real, counts = T._copy_piece, []

    def spy(buf, lanes, piece):
        n = real(buf, lanes, piece)
        counts.append((threading.current_thread().name, piece, n))
        return n

    monkeypatch.setattr(T, "_copy_piece", spy)
    rng = np.random.default_rng(6)
    segs = []
    for k in range(4):
        path = tmp_path / f"episode{k}.pcm"
        _noise(rng, 16000 * 20).tofile(path)
        segs.append(np.memmap(path, dtype=np.int16, mode="r"))
    before = metrics.snapshot()
    _dispatch(segs, 16000, 1)
    assert sorted(len(p) for _, p, _ in counts) == [1] * 4
    assert len({t for t, _, _ in counts}) > 1
    assert all(n > 0 for _, _, n in counts)
    assert _counted("ingest.lane_copy_faults", before) == sum(n for _, _, n in counts)


@pytest.mark.parametrize("cores,lanes,want", [
    (8, 8, 7), (64, 8, 8), (3, 8, 2), (2, 8, 0), (1, 8, 0), (8, 2, 2), (8, 4, 4)])
def test_pool_size_follows_the_usable_cores(monkeypatch, cores, lanes, want):
    monkeypatch.setattr(T.os, "sched_getaffinity", lambda pid: set(range(cores)),
                        raising=False)
    monkeypatch.setattr(T, "LANES", lanes)
    assert T._copy_threads() == want
    fresh = T._CopyPool()
    pool, threads = fresh._executor()
    assert threads == want and (pool is None) == (want == 0)
    assert fresh._executor()[0] is pool  # started once, then kept
    if pool is not None:
        pool.shutdown()


@pytest.mark.parametrize("extents,n", [([5, 0, 7], 3), ([1, 1, 1, 1], 4), ([9], 4),
                                       ([48000 * 2, 17, 3], 8)])
def test_pieces_tile_the_lanes(extents, n):
    pieces = T._lane_pieces(extents, n)
    assert len(pieces) == n
    total = sum(extents)
    assert [b - a for p in pieces for _, a, b in p] and all(
        a < b for p in pieces for _, a, b in p)
    sizes = [sum(b - a for _, a, b in p) for p in pieces]
    assert sum(sizes) == total and max(sizes) - min(sizes) <= 1
    flat = [(r, a, b) for p in pieces for r, a, b in p]
    for r, e in enumerate(extents):
        runs = [(a, b) for rr, a, b in flat if rr == r]
        assert sum(b - a for a, b in runs) == e
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(runs, runs[1:]))
