"""needle-tpu-torch: the needle-tpu opening/ending finder on PyTorch and CUDA.

A port of :mod:`needle_tpu` (JAX on a TPU) to PyTorch on an NVIDIA GPU,
which it stays beside as the reference. It reuses needle_tpu's jax-free
host layers (data files, durations, ingest, voting, skip files) and runs
the device work in PyTorch:

  * :class:`Analyzer` — raw-PCM episodes -> :class:`FrameHashes` through
    the fused ingest (decimate, downmix, resample, fingerprint) on a torch
    device, with hashes bit-exact against the canonical host oracle.
  * :class:`Comparator` — all-pairs opening/ending search whose
    diagonal-run count walk is a hand-written CUDA kernel
    (csrc/diag_runs.cu) on a card, and its plain PyTorch version on the
    CPU.

Both take ``device="cuda"`` (default) or ``"cpu"``; asking for cuda
without a card raises. This package imports torch and never jax.
"""

from needle_tpu.data import FrameHashes
from needle_tpu.duration import Duration

from .analyzer import Analyzer
from .comparator import Comparator

__all__ = ["Analyzer", "Comparator", "Duration", "FrameHashes"]
