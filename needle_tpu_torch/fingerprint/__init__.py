"""Chromaprint-compatible fingerprinting on PyTorch.

  * :mod:`needle_tpu_torch.fingerprint.torch_impl` — the fused raw-PCM
    ingest (decimate, downmix, resample, fingerprint) on a torch device.
  * :mod:`needle_tpu_torch.fingerprint.plan` — its static numpy tables.
  * :mod:`needle_tpu_torch.fingerprint.ingest_oracle` — the canonical host
    oracle its borderline hashes are rescanned with.
"""
