"""Multi-device runs of the port: one process per GPU.

The reference's parallelism is rayon thread pools over videos (analyze) and
over episode pairs (search) on one CPU (needle/src/audio/analyzer.rs:437-445,
comparator.rs:549-564). needle_tpu runs them on JAX device meshes: inside
one process its engines shard batch axes over a mesh (`make_mesh`,
`needle_mesh`, `set_mesh` / `get_mesh`, `replicate`, `shard_batch`), and
across processes `parallel.distributed` shards the work lists.

The port keeps only the second half, in PyTorch's idiom: each GPU gets a
process of its own (torchrun, or any launcher that gives each process its
rank), which builds its Analyzer and Comparator on :func:`local_device` and
runs its share of the episodes and of the pair list through
:mod:`needle_tpu_torch.parallel.distributed`; the shares are exchanged
with `torch.distributed` collectives (NCCL on cards, gloo on the CPU) and
finalized identically in every process. The mesh helpers have no
counterpart:

  * in PyTorch one process drives one GPU, and collectives join the
    processes; an in-process split of the ingest lanes or walk chunks over
    several GPUs would be a second way to do the same thing;
  * such a split could not be tested: the CPU build of torch has one CPU
    device, and the card machine has one GPU.

The work is embarrassingly parallel (no cross-episode or cross-pair
communication), so a process per GPU loses nothing: each search process
holds the whole episode hash table (O(episodes x n_pad x 4 B), ~10 MB for
1000 episodes) and walks its shard of the pairs.

    torchrun --nproc-per-node=4 my_run.py
    # in my_run.py:
    from needle_tpu_torch.parallel import local_device
    import needle_tpu_torch.parallel.distributed as dist
    dist.initialize()
    analyzer = Analyzer.from_files(videos, device=local_device())
    dist.distributed_analyze(analyzer, 0.3)
"""

from __future__ import annotations

import os

import torch

__all__ = ["local_device", "local_rank"]


def local_rank() -> int:
    """This process's GPU index on its host: LOCAL_RANK (torchrun sets it),
    else the distributed rank modulo the host's GPU count, else 0."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    import torch.distributed as dist

    if (dist.is_available() and dist.is_initialized()
            and torch.cuda.is_available()):
        return dist.get_rank() % torch.cuda.device_count()
    return 0


def local_device(device: str = "cuda") -> torch.device:
    """The device this process runs on — the counterpart of needle_tpu's
    `local_mesh`: cuda:<local rank>, or the CPU when asked for "cpu".
    There is no fallback: "cuda" without a card raises."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is False"
        )
    return torch.device("cuda", local_rank())
