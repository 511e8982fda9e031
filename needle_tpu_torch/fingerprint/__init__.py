"""Chromaprint-compatible fingerprinting on PyTorch.

  * :mod:`needle_tpu_torch.fingerprint.torch_impl` — the fused raw-PCM
    ingest (decimate, downmix, resample, fingerprint) on a torch device.
  * :mod:`needle_tpu_torch.fingerprint.plan` — its static numpy tables.
  * :mod:`needle_tpu_torch.fingerprint.ingest_oracle` — the canonical host
    oracle its borderline hashes are rescanned with.
  * :mod:`needle_tpu_torch.fingerprint.numpy_impl`,
    :mod:`~needle_tpu_torch.fingerprint.constants`,
    :mod:`~needle_tpu_torch.fingerprint.decimate` — the numpy fingerprint
    (`fingerprint_numpy`, the mono route's oracle), the chromaprint
    constants and the half-band taps: copies of needle_tpu's.
    `fingerprint_numpy_stereo` is the `numpy` analyze backend.
  * :mod:`needle_tpu_torch.fingerprint.oracle` — the ctypes binding of the
    system libchromaprint: the `chromaprint` analyze backend.
"""
