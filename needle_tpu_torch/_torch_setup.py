"""Numeric settings and device selection for the PyTorch port.

The JAX package runs its fingerprint matmuls at Precision.HIGHEST
(needle_tpu/fingerprint/jax_impl.py:60): full float32 accumulation. On an
NVIDIA card PyTorch may otherwise route float32 products through TF32
(about three decimal digits), which would push classifier values far past
the 1e-5 borderline margin the exact rescan relies on. `ensure` pins full
float32 for matmuls and convolutions, and full-precision reductions for
reduced-precision products.
"""

from __future__ import annotations

import torch

_initialized = False


def ensure() -> None:
    """Pin full-precision float32 arithmetic (idempotent)."""
    global _initialized
    if _initialized:
        return
    _initialized = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(name) -> torch.device:
    """'cuda' or 'cpu' (or a torch.device of either type) -> torch.device.

    There is no automatic choice: asking for 'cuda' on a machine without a
    usable CUDA device raises instead of running somewhere else."""
    ensure()
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is False"
        )
    if device.type in ("cuda", "cpu"):
        return device
    raise ValueError(f"unsupported device {name!r}: expected 'cuda' or 'cpu'")
