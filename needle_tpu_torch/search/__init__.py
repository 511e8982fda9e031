"""Cross-episode search on PyTorch.

  * :mod:`needle_tpu_torch.search.diag_runs` — the diagonal-run count walk:
    the CUDA kernel's wrapper and its plain PyTorch version.
  * :mod:`needle_tpu_torch.search.torch_impl` — `TorchSearchEngine`, the
    batched all-pairs engine (port of needle_tpu's JaxSearchEngine).
  * :mod:`needle_tpu_torch.search.host` — the host-side entry assembly it
    shares with needle_tpu's engines.
"""

from .torch_impl import TorchSearchEngine

__all__ = ["TorchSearchEngine"]
