"""needle-tpu-torch: the needle-tpu opening/ending finder on PyTorch and CUDA.

A port of :mod:`needle_tpu` (JAX on a TPU) to PyTorch on an NVIDIA GPU,
which it stays beside as the reference. It is a package of its own: it
imports torch, never jax, and nothing of needle_tpu. Its host layers (data
files, durations, ingest, voting, skip files, the CLI) are its own copies
of needle_tpu's, held equal to them by the differential tests, and it runs
the device work in PyTorch:

  * :class:`Analyzer` — episodes -> :class:`FrameHashes` through the fused
    raw-PCM ingest (decimate, downmix, resample, fingerprint) or the
    pre-decoded mono route on a torch device, with hashes bit-exact
    against the canonical host oracle.
  * :class:`Comparator` — all-pairs opening/ending search whose
    diagonal-run count walk is a hand-written CUDA kernel
    (csrc/diag_runs.cu) on a card, and its plain PyTorch version on the
    CPU.

Both take ``device="cuda"`` (default) or ``"cpu"``; asking for cuda
without a card raises.
"""

from .analyzer import Analyzer
from .comparator import Comparator
from .data import FrameHashes
from .duration import Duration

__all__ = ["Analyzer", "Comparator", "Duration", "FrameHashes"]
