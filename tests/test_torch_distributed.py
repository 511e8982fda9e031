"""Multi-process runs of the port over torch.distributed: 2 and 4 gloo
processes on the CPU, as tests/test_distributed.py runs needle_tpu's over
jax.distributed.

Each process joins the group with `initialize(tcp://..., device="cpu")`,
analyzes its round-robin share of a 4 x 90 s season
(`distributed_analyze`), and searches its share of the pair list
(`distributed_search`). Every process must return the same SearchResults,
equal to a single-process search with the port's Comparator and with
needle_tpu's `Comparator.run_with_frame_hashes`; the `.needle.dat` files
equal a single-process analyze byte for byte; only the coordinator writes
skip files."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import json
import sys
from pathlib import Path

sys.path.insert(0, sys.argv[1])

import numpy as np
import torch

torch.set_num_threads(2)

import needle_tpu_torch.parallel.distributed as dist
from needle_tpu_torch import Analyzer, Comparator
from needle_tpu_torch.data import FrameHashes, frame_hash_data_path
from needle_tpu_torch.duration import Duration
from needle_tpu_torch.parallel import local_device

addr, pid, season, nproc, out = sys.argv[2:7]
pid, nproc = int(pid), int(nproc)

dist.initialize(addr, num_processes=nproc, process_id=pid, device="cpu")
dist.initialize(addr, num_processes=nproc, process_id=pid, device="cpu")
assert dist.is_initialized()
assert dist.process_count() == nproc
assert dist.is_coordinator() == (pid == 0)
assert dist._allgather_bytes(bytes([pid]) * (pid + 1)) == [
    bytes([p]) * (p + 1) for p in range(nproc)]
dev = local_device("cpu")

paths = sorted(Path(season).glob("*.wav"))
hd = Duration.from_secs_f32(np.float32(0.3))
analyzer = Analyzer.from_files(paths, device=dev).with_include_endings(True)
local = dist.distributed_analyze(analyzer, hd, persist=True)
assert len(local) == len(paths[pid::nproc]), len(local)

# every process loads the union: the barrier in distributed_analyze made
# every share's .needle.dat exist
fhs = [FrameHashes.from_path(frame_hash_data_path(p)) for p in paths]
writes = []
create = Comparator.create_skip_file


def counted(self, video, result):
    writes.append(Path(video).name)
    return create(self, video, result)


Comparator.create_skip_file = counted
cmp = Comparator(paths, device=dev).with_include_endings(True)
results = dist.distributed_search(cmp, fhs, write_skip_files=True)


def nanos(span):
    return None if span is None else [d.total_nanos() for d in span]


Path(out).write_text(json.dumps({
    "results": [[nanos(r.opening), nanos(r.ending)] for r in results],
    "skip_writes": writes,
}))
dist.barrier()
torch.distributed.destroy_process_group()
print(f"process {pid}: OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nanos(span):
    return None if span is None else [d.total_nanos() for d in span]


def _run_workers(tmp_path, season, nproc, timeout):
    """Start nproc workers with their output in files (pipes could fill
    while the workers wait on each other's collectives), wait for all with
    one deadline, and kill every worker on the first failure."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    addr = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs, logs = [], []
    for pid in range(nproc):
        log = open(tmp_path / f"worker{pid}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(REPO), addr, str(pid),
             str(season), str(nproc), str(tmp_path / f"out{pid}.json")],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((pid for pid, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for log in logs:
            log.close()
    text = {pid: (tmp_path / f"worker{pid}.log").read_text()
            for pid in range(nproc)}
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"process {pid} failed:\n{text[pid]}"
        assert f"process {pid}: OK" in text[pid]
    return [json.loads((tmp_path / f"out{pid}.json").read_text())
            for pid in range(nproc)]


@pytest.mark.parametrize("nproc", [2, 4])
def test_gloo_processes_equal_single_process(tmp_path, nproc):
    """2 processes split the episodes 2/2 and the pairs 3/3; 4 processes
    give shares of one episode and uneven pair shares (2/2/1/1)."""
    import needle_tpu.comparator as j_comparator
    import needle_tpu.data as j_data
    from needle_tpu_torch import Analyzer, Comparator
    from needle_tpu_torch.data import FrameHashes, frame_hash_data_path
    from needle_tpu_torch.duration import Duration
    from needle_tpu_torch.testing import make_synthetic_season

    season = tmp_path / "season"
    # opening and ending exceed the default 20 s minimum
    paths, _, _ = make_synthetic_season(
        season, num_episodes=4, episode_secs=90, opening_secs=25,
        ending_secs=25, seed=13,
    )
    outs = _run_workers(tmp_path, season, nproc, timeout=240 + 60 * nproc)

    # every process finalized the same union
    assert all(o["results"] == outs[0]["results"] for o in outs[1:])
    results = outs[0]["results"]
    assert len(results) == 4 and all(op is not None for op, _ in results)
    # skip files were written by the coordinator alone, once per episode
    assert sorted(outs[0]["skip_writes"]) == sorted(p.name for p in paths)
    assert all(o["skip_writes"] == [] for o in outs[1:])
    assert len(list(season.glob("*.needle.skip.json"))) == 4

    # the shares' .needle.dat files equal a single-process analyze
    hd = Duration.from_secs_f32(np.float32(0.3))
    single = Analyzer(paths, device="cpu").with_include_endings(True).run(
        hd, persist=False)
    for p, fh in zip(paths, single):
        assert frame_hash_data_path(p).read_bytes() == fh.to_bytes(), p.name

    # the results equal a single-process search, the port's and needle_tpu's
    fhs = [FrameHashes.from_path(frame_hash_data_path(p)) for p in paths]
    ours = Comparator(paths, device="cpu").with_include_endings(True)
    want = [[_nanos(r.opening), _nanos(r.ending)]
            for r in ours.run_with_frame_hashes(fhs, False, False, False)]
    assert results == want
    j_fhs = [j_data.FrameHashes.from_path(frame_hash_data_path(p)) for p in paths]
    ref = j_comparator.Comparator(paths).with_include_endings(True)
    j_want = [[_nanos(r.opening), _nanos(r.ending)]
              for r in ref.run_with_frame_hashes(j_fhs, False, False, False)]
    assert results == j_want


def test_world_of_one_without_initialize():
    """Without a process group every helper acts as a world of one."""
    import needle_tpu_torch.parallel.distributed as dist
    from needle_tpu_torch.parallel import local_device, local_rank

    if torch.distributed.is_initialized():
        pytest.skip("a process group exists in this process")
    assert dist.process_count() == 1 and dist.is_coordinator()
    assert dist.local_shard(range(5)) == [0, 1, 2, 3, 4]
    assert dist._allgather_bytes(b"needle") == [b"needle"]
    dist.barrier()
    assert local_device("cpu") == torch.device("cpu")
    assert local_rank() == int(os.environ.get("LOCAL_RANK", "0"))
    with pytest.raises(ValueError):
        local_device("tpu")


def test_initialize_refuses_what_it_cannot_do():
    """No fallback: "cuda" without a card raises before any group exists,
    and a half-given address is refused."""
    import needle_tpu_torch.parallel.distributed as dist
    from needle_tpu_torch.parallel import local_device

    with pytest.raises(ValueError, match="together"):
        dist.initialize("127.0.0.1:1", num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        dist.initialize(device="tpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dist.initialize("127.0.0.1:1", num_processes=1, process_id=0)
    with pytest.raises(RuntimeError, match="cuda"):
        local_device()
    assert not dist.is_initialized()


_ENV_WORKER = r"""
import sys
import numpy as np
import torch.distributed

import needle_tpu_torch.parallel.distributed as dist
from needle_tpu_torch.comparator import Comparator
from needle_tpu_torch.data import FrameHashes
from needle_tpu_torch.duration import Duration
from needle_tpu_torch.parallel import local_device, local_rank

dist.initialize(device="cpu")  # torchrun's environment
assert dist.is_initialized() and torch.distributed.get_backend() == "gloo"
assert (dist.process_count(), local_rank()) == (1, 0)
rng = np.random.default_rng(3)
shared = rng.integers(0, 2**32, size=120, dtype=np.uint32)
fhs = []
for e in range(3):
    h = rng.integers(0, 2**32, size=500, dtype=np.uint32)
    h[20 + 30 * e : 140 + 30 * e] = shared
    ts = (2600090703 + np.arange(500) * 247619033).astype(np.int64)
    fhs.append(FrameHashes(h, ts, np.zeros(0, np.uint32), np.zeros(0, np.int64),
                           Duration.from_millis(300), f"{e:032x}"))
videos = [f"e{k}.mkv" for k in range(3)]
cmp = Comparator(videos, device=local_device("cpu"))
got = dist.distributed_search(cmp, fhs)
want = cmp.run_with_frame_hashes(fhs, False, False, False)
assert [r.opening for r in got] == [r.opening for r in want]
assert all(r.opening is not None for r in got)
torch.distributed.destroy_process_group()
print("OK")
"""


def test_initialize_from_torchrun_environment(tmp_path):
    """With no arguments initialize reads torchrun's variables (env://)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0",
               LOCAL_RANK="0", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _ENV_WORKER], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"
