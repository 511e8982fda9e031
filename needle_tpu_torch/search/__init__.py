"""Cross-episode search on PyTorch.

  * :mod:`needle_tpu_torch.search.diag_runs` — the diagonal-run count walk:
    the CUDA kernel's wrapper and its plain PyTorch version.
  * :mod:`needle_tpu_torch.search.torch_impl` — `TorchSearchEngine`, the
    batched all-pairs engine (port of needle_tpu's JaxSearchEngine).
  * :mod:`needle_tpu_torch.search.host` — its host-side entry assembly
    (copies of needle_tpu's helpers).
  * :mod:`needle_tpu_torch.search.oracle` — the reference-exact numpy
    search (`longest_common_hash_match`) and the RunEntry, heap-order and
    simhash helpers.
"""

from .torch_impl import TorchSearchEngine

__all__ = ["TorchSearchEngine"]
