"""The port on a CUDA card: the hand-written count walk kernel against its
plain PyTorch version, and the search engine and fused ingest on the card
against the same code on the CPU. These tests need an NVIDIA GPU and nvcc;
elsewhere they skip. This file imports no jax, so on a machine with a card
and without jax it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _t(a, device):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)


@pytest.mark.parametrize("n_pad,chunk", [(512, 5), (2560, 64), (7168, 3)])
def test_kernel_equals_reference(dev, n_pad, chunk):
    """Exact on planted runs with nv/mv < n_pad, thr 0 and 10, l_min 1,
    band masks with gaps, a padding lane, and (at 7168) more than 48 KB
    of shared memory."""
    from needle_tpu_torch.search import diag_runs as D

    rng = np.random.default_rng(n_pad + chunk)
    src = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    for p in range(chunk):
        n = int(rng.integers(40, 300))
        s0, d0 = rng.integers(1, n_pad - n, size=2)
        dst[p, d0 : d0 + n] = src[p, s0 : s0 + n]
        dst[p, d0 + n // 3] ^= np.uint32(1)
    nv = rng.integers(n_pad // 2, n_pad + 1, size=chunk).astype(np.int32)
    mv = rng.integers(n_pad // 2, n_pad + 1, size=chunk).astype(np.int32)
    thr = np.where(np.arange(chunk) % 2 == 0, 10, 0).astype(np.int32)
    lm = np.where(np.arange(chunk) % 3 == 0, 1, 30).astype(np.int32)
    bm = np.full((chunk, D.n_groups_for(n_pad)), D.full_block_mask(n_pad), np.int32)
    bm[1::4] &= rng.integers(0, 2**31, size=bm[1::4].shape).astype(np.int32)
    lm[-1], bm[-1] = INT32_MAX, 0  # a padding lane
    args = [_t(a, dev) for a in (nv, mv, lm, thr, src, dst)] + [n_pad, _t(bm, dev)]
    before = D.LAUNCHES
    got = D.batch_counts(*args)
    torch.cuda.synchronize()
    assert D.LAUNCHES == before + 1
    want = D.batch_counts_reference(*args)
    assert torch.equal(got, want)
    assert int((want > 0).sum()) > 0
    assert not got[-1].any()


def test_kernel_rejects_bad_operands(dev):
    from needle_tpu_torch.search import diag_runs as D

    x = torch.zeros((2, 500), dtype=torch.int32, device=dev)
    s = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        D.batch_counts(s, s, s, s, x, x, 500)  # n_pad not a multiple of 512
    y = torch.zeros((2, 512), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        D.batch_counts(s, s, s, s, y, y, 512)


def test_engine_on_card_equals_cpu(dev):
    from needle_tpu.data import FrameHashes
    from needle_tpu.duration import Duration
    from needle_tpu_torch import Comparator

    rng = np.random.default_rng(5)
    shared = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    fhs = []
    for e in range(5):
        h = rng.integers(0, 2**32, size=900 + 37 * e, dtype=np.uint32)
        h[40 + 13 * e : 160 + 13 * e] = shared
        ts = (2600090703 + np.arange(len(h)) * 247619033).astype(np.int64)
        fhs.append(FrameHashes(h, ts, h[::-1].copy(), ts, Duration.from_millis(300),
                               f"{e:032x}"))

    def run(device):
        cmp = Comparator([f"e{k}.wav" for k in range(5)], device=device)
        cmp = cmp.with_include_endings(True)
        infos = cmp.search_pair_infos(fhs, cmp.pair_order(5))
        return [[list(x) for x in (i.src_openings, i.src_endings)] for i in infos]

    assert run("cuda") == run("cpu")


def test_ingest_on_card_equals_oracle(dev):
    from needle_tpu_torch.fingerprint import ingest_oracle as O
    from needle_tpu_torch.fingerprint import torch_impl as T

    rng = np.random.default_rng(11)
    for rate, ch in ((16000, 1), (44100, 2)):
        seg = (rng.standard_normal(rate * ch * 8) * 6000).astype(np.int16)
        got = T.fingerprint_ingest_batch([seg], rate, ch, device="cuda")[0]
        d = T.IngestDispatcher(rate, ch, "cuda")
        n_sub, nf_b = d.lane_geometry(len(seg))
        want = O.ingest_hashes_full_oracle(seg, len(seg), rate, ch, d.dec_factor,
                                           nf_b, n_sub)
        np.testing.assert_array_equal(got, want)
        vals, _, dec, nf_b = T.ingest_classifier_values(seg, rate, ch, device="cuda")
        ref, _ = O.ingest_values_oracle(seg, len(seg), rate, ch, dec, nf_b, len(vals))
        assert np.max(np.abs(vals - ref)) < 5e-6
