"""Multi-process runs over torch.distributed: one process per GPU.

The reference has no distributed backend at all (single process + rayon);
needle_tpu scales out with `jax.distributed`. This is the port's
counterpart, with needle_tpu's names and contract on `torch.distributed`:
`initialize` joins the processes (NCCL between cards, gloo on the CPU),
`distributed_analyze` analyzes each process's round-robin share of the
episodes, and `distributed_search` walks each process's share of the
reference's pair list, all-gathers the per-pair infos and finalizes the
same union everywhere, so every process returns the SearchResults that a
single-process `Comparator.run_with_frame_hashes` returns.

    import needle_tpu_torch.parallel.distributed as dist
    from needle_tpu_torch.parallel import local_device
    dist.initialize()          # torchrun's environment, NCCL on the card
    dev = local_device()
    dist.distributed_analyze(Analyzer.from_files(videos, device=dev), 0.3)
    fhs = [FrameHashes.from_video(v) for v in videos]
    dist.distributed_search(Comparator(videos, device=dev), fhs)

File IO stays per host: each process analyzes the episodes of its share
(`.needle.dat` next to each video, on a filesystem every process sees),
and results are displayed and skip files written by process 0
(`is_coordinator()`). Without `initialize` every function acts as a world
of one.
"""

from __future__ import annotations

import copy
import os
import pickle
from typing import List, Optional

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Join this process to the process group (idempotent: a process that
    is in a group already stays in it).

    With no arguments the group is read from torchrun's environment
    (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). Explicit
    arguments support manual clusters:
    initialize("10.0.0.1:8476", num_processes=4, process_id=0), over
    `tcp://`. device "cuda" (default) joins over NCCL and binds this
    process to cuda:<local rank>; "cpu" joins over gloo. Nothing falls
    back: "cuda" without a card or without NCCL raises."""
    if dist.is_initialized():
        return
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize(device='cuda'): torch.cuda.is_available() is False"
            )
        if not dist.is_nccl_available():
            raise RuntimeError("initialize(device='cuda'): NCCL is not available")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")

    explicit = (coordinator_address, num_processes, process_id)
    if all(a is None for a in explicit):
        kwargs = {"init_method": "env://"}
    elif any(a is None for a in explicit):
        raise ValueError(
            "initialize: give coordinator_address, num_processes and "
            "process_id together, or none of them (torchrun's environment)"
        )
    else:
        address = coordinator_address
        if "://" not in address:
            address = f"tcp://{address}"
        kwargs = {"init_method": address, "world_size": int(num_processes),
                  "rank": int(process_id)}
    if backend == "nccl":
        # NCCL's collectives run on the current device: bind it first, to
        # the GPU that local_rank() names once the group exists
        rank = kwargs.get("rank", int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, **kwargs)


def is_initialized() -> bool:
    return dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process that should perform singleton side effects
    (result display, skip-file writes for shared filesystems)."""
    return _rank() == 0


def local_shard(items) -> list:
    """Round-robin shard a list of work items (e.g. video paths) across
    processes — the episodes-axis analog of the reference's rayon fan-out,
    at the process level."""
    return list(items)[_rank() :: process_count()]


def _nccl() -> bool:
    return dist.is_initialized() and dist.get_backend() == "nccl"


def barrier(name: str = "needle-barrier") -> None:
    """Cross-process synchronization point: no process proceeds until all
    reach it. `name` labels it for symmetry with needle_tpu's."""
    if not dist.is_initialized():
        return
    if _nccl():
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """All-gather one bytes blob per process. Returns the list of every
    process's blob, ordered by process index: the lengths first, then the
    blobs padded to the longest as uint8 tensors, on the backend's device
    (the card for NCCL, the CPU for gloo)."""
    if not dist.is_initialized():
        return [bytes(payload)]
    device = (torch.device("cuda", torch.cuda.current_device()) if _nccl()
              else torch.device("cpu"))
    world = dist.get_world_size()
    n = torch.tensor([len(payload)], dtype=torch.int64, device=device)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    lens = [int(x.item()) for x in lens]
    buf = torch.zeros(max(1, max(lens)), dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    buf = buf.to(device)
    gathered = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(gathered, buf)
    return [g[:k].cpu().numpy().tobytes() for g, k in zip(gathered, lens)]


def distributed_analyze(analyzer, hash_duration, persist: bool = True):
    """Analyze this process's episode shard (round-robin over processes),
    then synchronize so every shard's `.needle.dat` files exist before
    anyone searches. Returns this process's local FrameHashes."""
    sub = copy.copy(analyzer)
    sub.videos = local_shard(analyzer.videos)
    results = sub.run(hash_duration, persist=persist) if sub.videos else []
    barrier("needle-analyze-done")
    return results


def distributed_search(
    comparator,
    frame_hashes,
    display: bool = False,
    use_skip_files: bool = False,
    write_skip_files: bool = False,
):
    """All-pairs search with the PAIR LIST sharded across processes.

    Each process runs the comparator's engine on its device over its shard
    of the reference's pair order; the non-empty per-pair infos are
    exchanged with an all-gather, and every process rebuilds them in the
    reference's pair order before voting (voting order decides ties), so
    all processes return the results of a single-process search.
    Singleton side effects (display, skip-file writes) happen only on the
    coordinator."""
    n = len(comparator.videos)
    pairs = comparator.pair_order(n)
    mine = local_shard(pairs)
    infos = comparator.search_pair_infos(frame_hashes, mine) if mine else []
    keep = [
        ((i, j), info)
        for (i, j), info in zip(mine, infos)
        if not info.is_empty()
    ]
    merged = {}
    # the blobs come from this program's own processes
    for blob in _allgather_bytes(pickle.dumps(keep)):
        for key, info in pickle.loads(blob):
            merged[key] = info
    data = [(i, j, merged[(i, j)]) for (i, j) in pairs if (i, j) in merged]
    lead = is_coordinator()
    return comparator.finalize_results(
        data,
        display=display and lead,
        use_skip_files=use_skip_files,
        write_skip_files=write_skip_files and lead,
    )
