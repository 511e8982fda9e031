"""The fused ingest's staging ring (needle_tpu_torch/fingerprint/
torch_impl.py::_StagingRing), on the CPU: the same code as on a card, but
for the page-locking.

Every IngestDispatcher of a process stages its lane chunks in two reused
host buffers and clears no lane: what an earlier chunk left in a slot must
never reach a hash. Each case compares with the canonical whole-lane oracle
and with the segment fingerprinted alone, after louder chunks have gone
through the same slots."""

import sys
import threading

import numpy as np
import pytest
import torch

from needle_tpu_torch.fingerprint import ingest_oracle as O
from needle_tpu_torch.fingerprint import torch_impl as T
from needle_tpu_torch.tracing import metrics


def _noise(rng, n, amp=6000):
    return (rng.standard_normal(n) * amp).astype(np.int16)


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring, and two lanes a chunk."""
    monkeypatch.setattr(T, "LANES", 2)
    fresh = T._StagingRing()
    monkeypatch.setattr(T, "_staging", fresh)
    return fresh


def _dispatch(segs, rate=16000, channels=1, n_valids=None, threading_=True):
    d = T.IngestDispatcher(rate, channels, "cpu", threading=threading_)
    for i, s in enumerate(segs):
        d.add(i, s, None if n_valids is None else n_valids[i])
    out = d.finish()
    return [out[i] for i in range(len(segs))]


def _oracle(seg, rate=16000, channels=1, n_valid=None):
    d = T.IngestDispatcher(rate, channels, "cpu")
    n_valid = len(seg) if n_valid is None else n_valid
    n_sub, nf_b = d.lane_geometry(n_valid)
    return O.ingest_hashes_full_oracle(seg, n_valid, rate, channels,
                                       d.dec_factor, nf_b, n_sub)


def _counts():
    snap = metrics.snapshot()
    return tuple(snap.get(k, (0.0, 0))[1]
                 for k in ("ingest.staging_hits", "ingest.staging_misses"))


def _loud(ring, rate=16000, channels=1, secs=(25, 25, 25, 25)):
    """Fill both slots with full-scale noise: two chunks of two lanes."""
    rng = np.random.default_rng(99)
    _dispatch([_noise(rng, rate * channels * s, 30000) for s in secs],
              rate, channels)
    assert all(slot.raw is not None for slot in ring._slots)


@pytest.mark.parametrize("threading_", [True, False])
def test_two_buckets_then_a_second_dispatcher(ring, threading_):
    """Three chunks of buckets 160 and 224 at 16 kHz mono, then a second
    dispatcher at 44.1 kHz stereo through the same slots."""
    rng = np.random.default_rng(13)
    mono = [_noise(rng, 16000 * s) for s in (5, 25, 6, 25, 9)]
    stereo = [_noise(rng, 44100 * 2 * s) for s in (6, 24, 9)]
    for segs, rate, ch in ((mono, 16000, 1), (stereo, 44100, 2)):
        got = _dispatch(segs, rate, ch, threading_=threading_)
        for g, s in zip(got, segs):
            assert g.dtype == np.uint32
            want = _oracle(s, rate, ch)
            np.testing.assert_array_equal(g, want)
            np.testing.assert_array_equal(
                T.fingerprint_ingest_batch([s], rate, ch, device="cpu")[0], want)


@pytest.mark.parametrize("rate,channels", [(16000, 1), (44100, 2)])
def test_partial_chunk_after_full_ones(ring, rate, channels):
    """A chunk of one lane of two, in a slot whose second lane and whose
    first lane's tail still hold an earlier chunk's louder samples; the
    empty lane's valid count is written as 0."""
    _loud(ring, rate, channels)
    seg = _noise(np.random.default_rng(5), rate * channels * 20)
    got = _dispatch([seg], rate, channels)[0]
    np.testing.assert_array_equal(got, _oracle(seg, rate, channels))
    staged = [slot.nv[: T.LANES].tolist() for slot in ring._slots]
    assert [20 * rate, 0] in staged


def test_segment_shorter_than_its_valid_count(ring):
    """A lane whose segment ends before its n_valid: the samples between
    them are zeros, not what the slot held."""
    _loud(ring)
    rng = np.random.default_rng(7)
    short, other = _noise(rng, 16000 * 12), _noise(rng, 16000 * 25)
    n_valids = [16000 * 20, len(other)]
    got = _dispatch([short, other], n_valids=n_valids)
    np.testing.assert_array_equal(got[0], _oracle(short, n_valid=n_valids[0]))
    np.testing.assert_array_equal(got[1], _oracle(other))


def test_two_threads_at_once(ring):
    """Two threads, each with its own dispatchers, through one ring: each
    gets what it gets alone."""
    rng = np.random.default_rng(21)
    sets = [[_noise(rng, 16000 * s) for s in (5, 25, 6, 25, 9, 24)]
            for _ in range(2)]
    want = [[_oracle(s) for s in segs] for segs in sets]
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def run(k):
        try:
            start.wait()
            got[k] = [_dispatch(sets[k]) for _ in range(2)]
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for k in range(2):
        for rnd in got[k]:
            for g, w in zip(rnd, want[k]):
                np.testing.assert_array_equal(g, w)


def test_held_slots_stage_in_buffers_of_their_own(ring):
    """With both slots held by other threads, a chunk is staged in new
    buffers and counted as a miss, and the held slots are left alone."""
    held = [ring.take(), ring.take()]
    assert ring.take() is None
    rng = np.random.default_rng(3)
    segs = [_noise(rng, 16000 * s) for s in (5, 6, 25)]
    before = _counts()
    got = _dispatch(segs)
    hits, misses = (a - b for a, b in zip(_counts(), before))
    assert (hits, misses) == (0, 2)
    assert all(slot.raw is None and slot.held for slot in held)
    for g, s in zip(got, segs):
        np.testing.assert_array_equal(g, _oracle(s))
    for slot in held:
        ring.release(slot, None)
    assert ring.take() is not None


def test_misses_on_the_first_pass_hits_on_the_second(ring):
    """Two chunks a pass (buckets 160 and 224): the first pass allocates
    both slots, the second stages in them; each staging waits once."""
    rng = np.random.default_rng(17)
    segs = [_noise(rng, 16000 * s) for s in (5, 25, 6, 25)]
    for want in ((0, 2), (2, 0), (2, 0)):
        before = _counts()
        waits0 = metrics.snapshot().get("ingest.staging_wait", (0.0, 0))[1]
        _dispatch(segs)
        assert tuple(a - b for a, b in zip(_counts(), before)) == want
        assert metrics.snapshot()["ingest.staging_wait"][1] - waits0 == 2
    sizes = sorted(slot.raw.numel() for slot in ring._slots)
    d = T.IngestDispatcher(16000, 1, "cpu")
    in_lens = [T.plan._ingest_dims(d.mid_rate, nf_b)[1] * d.dec_factor
               for nf_b in (160, 224)]
    assert sizes == [T.LANES * n for n in in_lens]


def test_device_gray_table():
    table = T._device_gray(torch.device("cpu"))
    assert table.dtype == torch.int64 and table.tolist() == list(T._GRAY)
    assert T._device_gray(torch.device("cpu")) is table


def test_no_slot_is_held_twice():
    """32 threads taking and handing back the slots of one ring, with the
    interpreter switching threads every microsecond: no slot is ever held
    by two of them at once."""
    ring = T._StagingRing()
    owners, lock, clashes = {}, threading.Lock(), []

    def churn():
        for _ in range(300):
            slot = ring.take()
            if slot is None:
                continue
            with lock:
                if id(slot) in owners:
                    clashes.append(slot)
                owners[id(slot)] = threading.get_ident()
            with lock:
                del owners[id(slot)]
            ring.release(slot, None)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not clashes
    assert all(not slot.held for slot in ring._slots)
